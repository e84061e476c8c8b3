"""The port's examples (``examples/torch_*.py``) run on the CPU at small
sizes, each ``main(...)`` in a process of its own with a timeout of its
own, and print what the reference's examples print: rel err at or below
1e-4 on the exact paths, and the tokens generated."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(name: str, call: str, timeout: float) -> str:
    code = ("import runpy\n"
            f"ns = runpy.run_path({os.path.join(ROOT, 'examples', name)!r})\n"
            f"ns['main']({call})\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def rel_errs(out: str, label: str):
    return [float(v) for v in re.findall(
        rf"{label}.*?rel_err=([0-9.e+-]+)", out)]


def test_quickstart():
    out = run_example("torch_quickstart.py",
                      "m=24, n=40, max_iters=2000, device='cpu'", 240)
    (err,) = rel_errs(out, "exact PDHG")
    assert err <= 1e-4, out
    for dev in ("EpiRAM", "TaOx-HfOx"):
        assert re.search(rf"{dev}\s*: obj=.* \| energy: write", out), out


def test_serve_decode():
    out = run_example("torch_serve_decode.py",
                      "batch=2, prompt_len=4, gen_len=6, device='cpu'", 240)
    lines = re.findall(r"^(\S+)\s+\((\w+)\s*\): generated 6 tokens x 2 "
                       r"seqs .* sample: \[([0-9, ]+)\]$", out, re.M)
    assert [(a, m) for a, m, _ in lines] == [
        ("granite-3-8b", "gqa"), ("minicpm3-4b", "mla"),
        ("hymba-1.5b", "hybrid"), ("rwkv6-1.6b", "rwkv6")], out
    assert all(len(s.split(",")) == 10 for _, _, s in lines)


def test_analog_inference():
    out = run_example("torch_analog_inference.py",
                      "batch=4, seq=8, device='cpu'", 240)
    found = re.findall(r"^(\S+)\s*: argmax agreement (\d+)%  max logit "
                       r"drift ([0-9.]+)%.*, 4 analog MVMs\)$", out, re.M)
    assert [d for d, _, _ in found] == ["EpiRAM", "TaOx-HfOx"], out
    for _, agree, drift in found:
        assert 0 <= int(agree) <= 100 and float(drift) >= 0


@pytest.mark.parametrize("world", [4])
def test_distributed_pdhg(world):
    """Four gloo ranks: the sharded solves on a 2x2 and a 2x2x1 mesh and
    a batch of four LPs, each within 1e-4 of the known optimum."""
    out = run_example("torch_distributed_pdhg.py",
                      f"world={world}, m=24, n=40, batch_shape=(8, 14), "
                      "device='cpu', timeout=300", 360)
    assert f"ranks: {world} (gloo on cpu)" in out, out
    errs = (rel_errs(out, "sharded solve") + rel_errs(out, "multi-pod")
            + [float(v) for v in re.findall(r"max rel_err=([0-9.e+-]+)",
                                            out)])
    assert len(errs) == 3 and max(errs) <= 1e-4, out
    assert f"converged={world}/{world}" in out, out
