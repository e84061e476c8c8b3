"""Distributed crossbar array: the logical analog accelerator (paper §6);
the port of ``repro.crossbar.array``.

A grid of crossbar tiles holds the encoded symmetric block M.  One
logical MVM = broadcast input slices to every tile, each tile's analog
MVM runs in parallel, partial currents are summed along grid rows — no
matrix movement, no reprogramming.

  * ``CrossbarArray``          — the device-physics simulation
                                 (quantization, programming error,
                                 cycle-to-cycle read noise, energy and
                                 latency ledger).
  * ``crossbar_accel_factory`` — an ``Accel`` factory, so Algorithms 2-4
                                 run on it unchanged.
  * ``analog_linear``          — a noisy/quantized linear op through the
                                 same model.

With ``use_kernel=True`` each MVM is one launch of the hand-written CUDA
kernel B6 (``kernels.crossbar_mvm``; its plain version on CPU tensors);
with ``use_kernel=False`` it is the reference's plain product.  Both
draw the same per-row read noise: ``(R,)`` standard normals, not
clipped, from the array's own ``torch.Generator`` (seeded from the
programming seed, the counterpart of the reference's ``read_key``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..core.symblock import Accel, build_sym_block
from ..kernels.crossbar_mvm import crossbar_mvm
from .device import EPIRAM, DeviceModel
from .encode import EncodedMatrix, encode_matrix
from .energy import Ledger

# offset between the programming and the read-noise streams of one seed
# (the reference folds the same constant into its read key)
READ_STREAM = 0x52454144


@dataclasses.dataclass
class CrossbarArray:
    enc: EncodedMatrix
    ledger: Ledger
    device: DeviceModel
    use_kernel: bool = False
    # read-noise stream, on the conductances' device; seeded from the
    # programming seed so the whole device history is one seed
    generator: Optional[torch.Generator] = None

    def __post_init__(self):
        if self.generator is None:
            self.generator = torch.Generator(
                device=self.enc.g_pos.device).manual_seed(READ_STREAM)

    @classmethod
    def program(
        cls,
        W: torch.Tensor,
        device: DeviceModel = EPIRAM,
        seed: int = 0,
        ledger: Optional[Ledger] = None,
        use_kernel: bool = False,
    ) -> "CrossbarArray":
        """Encode ``W`` (on its own torch device) with draws seeded by
        ``seed``, charging the write to ``ledger``."""
        ledger = ledger if ledger is not None else Ledger()
        gen = torch.Generator(device=W.device).manual_seed(seed)
        enc = encode_matrix(W, device, gen, ledger=ledger)
        read = torch.Generator(device=W.device).manual_seed(
            seed + READ_STREAM)
        return cls(enc=enc, ledger=ledger, device=device,
                   use_kernel=use_kernel, generator=read)

    def mvm(self, v: torch.Tensor) -> torch.Tensor:
        """One logical analog MVM: w = W @ v with device non-idealities."""
        dev = self.device
        enc = self.enc
        R, C = enc.g_pos.shape
        vp = torch.zeros(C, dtype=enc.g_pos.dtype, device=enc.g_pos.device)
        vp[: enc.cols] = v
        z = torch.randn(R, generator=self.generator, dtype=vp.dtype,
                        device=vp.device)
        if self.use_kernel:
            w = crossbar_mvm(enc.g_pos, enc.g_neg, vp, enc.scale,
                             dev.sigma_read * z)
        else:
            w = torch.mv(enc.g_pos - enc.g_neg, vp) * enc.scale
            w = w * (1.0 + dev.sigma_read * z)
        # ledger: all tiles fire in parallel -> one read latency quantum;
        # energy scales with ACTIVE cells (zero conductances draw ~none)
        self.ledger.read_latency_s += dev.read_latency_s
        self.ledger.read_energy_j += (dev.read_energy_per_cell_j
                                      * enc.active_cells)
        self.ledger.mvm_count += 1
        return w[: enc.rows]


def crossbar_accel_factory(
    device: DeviceModel = EPIRAM,
    seed: int = 0,
    ledger: Optional[Ledger] = None,
    use_kernel: bool = False,
):
    """An ``accel_factory`` for ``core.pdhg.solve``: K -> Accel.

    Encodes the symmetric block M = [[0, K], [K^T, 0]] ONCE (Algorithm
    1), on K's device, with draws seeded by ``seed``; every later
    Algorithm-2 call is a read-only analog MVM."""
    led = ledger if ledger is not None else Ledger()

    def factory(K) -> Accel:
        m, n = K.shape
        arr = CrossbarArray.program(build_sym_block(K), device=device,
                                    seed=seed, ledger=led,
                                    use_kernel=use_kernel)
        acc = Accel(mvm_full=arr.mvm, m=m, n=n,
                    name=f"crossbar:{device.name}")
        acc.ledger = led          # exposed for the benchmark harness
        acc.array = arr
        return acc

    factory.ledger = led
    return factory


def analog_linear(x, W, device: DeviceModel = EPIRAM, seed: int = 0, *,
                  torch_device=None):
    """Noisy/quantized linear op  x @ W^T  through the crossbar model
    (weights encoded once; activations stream, one MVM each), on
    ``torch_device`` (default: the card)."""
    dev = resolve_device(torch_device)
    arr = CrossbarArray.program(torch.as_tensor(W, device=dev),
                                device=device, seed=seed)
    xs = torch.atleast_2d(torch.as_tensor(x, dtype=arr.enc.g_pos.dtype,
                                          device=dev))
    out = torch.stack([arr.mvm(xi) for xi in xs])
    return out.reshape((*x.shape[:-1], W.shape[0]))
