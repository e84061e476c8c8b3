"""Beyond-paper demo (the PyTorch port): LM inference through the
crossbar substrate.

The paper closes by noting its MVM-centric framework "is adaptable to a
broader class of ... machine learning problems".  This example runs a
tiny LM's final projection through the simulated analog crossbar
(encode-once weights, noisy reads) and measures how device noise
perturbs next-token argmax agreement.

    PYTHONPATH=src python examples/torch_analog_inference.py           # the card
    PYTHONPATH=src python examples/torch_analog_inference.py --device cpu
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.crossbar import EPIRAM, TAOX_HFOX, CrossbarArray
from repro_torch.models import forward, init_params
from repro_torch.models.lm import forward_hidden


def main(arch: str = "granite-3-8b", batch: int = 8, seq: int = 24,
         device=None):
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    B, S = batch, seq
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    with torch.no_grad():
        logits = forward(params, cfg, tokens=toks)      # digital reference
        # the backbone up to the final norm: logits = h @ E^T
        h_last = forward_hidden(params, cfg, tokens=toks)[:, -1, :]
    last = logits[:, -1, :].double()                    # (B, V)
    digital_next = last.argmax(-1)

    # re-do the final projection on the analog accelerator: encode the
    # (V, d) embedding matrix once, stream the hidden states
    E = params["embed"].double()
    out = {}
    for dev in (EPIRAM, TAOX_HFOX):
        arr = CrossbarArray.program(E, dev, seed=2)
        analog = torch.stack([arr.mvm(h_last[i].double()) for i in range(B)])
        agree = (analog.argmax(-1) == digital_next).double().mean().item()
        drift = ((analog - last).abs().max() / last.abs().max()).item()
        print(f"{dev.name:10s}: argmax agreement {agree*100:.0f}%  "
              f"max logit drift {drift*100:.1f}%  "
              f"(write {arr.ledger.write_energy_j*1e3:.2f} mJ, "
              f"{arr.ledger.mvm_count} analog MVMs)")
        out[dev.name] = (agree, drift)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
