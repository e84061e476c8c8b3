"""Serving example (the PyTorch port): batched greedy decoding with KV
caches across architecture families (GQA, MLA, hybrid attn+SSM, RWKV6).

    PYTHONPATH=src python examples/torch_serve_decode.py           # the card
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""
import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_cache, init_params
from repro_torch.train.serve_step import make_serve_step

ARCHS = ("granite-3-8b", "minicpm3-4b", "hymba-1.5b", "rwkv6-1.6b")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(archs=ARCHS, batch: int = 4, prompt_len: int = 8,
         gen_len: int = 24, device=None):
    device = resolve_device(device)
    out_all = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device=device)
        B = batch
        serve = make_serve_step(cfg)
        cache = init_cache(cfg, B, max_len=prompt_len + gen_len,
                           device=device)
        prompt = torch.randint(0, cfg.vocab, (B, prompt_len), generator=gen,
                               device=device, dtype=torch.int32)
        # prefill through the decode path (exactness over speed here)
        for t in range(prompt_len):
            tok, _, cache = serve(params, prompt[:, t:t + 1], cache)
        out = [prompt]
        cur = tok[:, None]
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(gen_len):
            tok, _, cache = serve(params, cur, cache)
            cur = tok[:, None]
            out.append(cur)
        _sync(device)
        dt = time.perf_counter() - t0
        seq = torch.cat(out, dim=1)
        print(f"{arch:18s} ({cfg.mixer:6s}): generated {gen_len} tokens x "
              f"{B} seqs in {dt:.2f}s "
              f"({B*gen_len/dt:.0f} tok/s) on {device.type}; sample: "
              f"{seq[0, :16].tolist()}")
        out_all[arch] = seq
    return out_all


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
