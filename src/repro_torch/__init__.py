"""repro_torch: the PyTorch/CUDA port of ``repro`` (in-memory PDHG for LPs).

The JAX package ``repro`` stays the reference; this package mirrors its
subpackage layout and public names, imports ``torch`` and numpy only,
and runs on ``cuda`` unless a caller asks for ``device="cpu"``.

Ported so far (the dense ``solve_jit`` path):

    lp/        containers and generators (numpy copies of ``repro.lp``)
    interop    carry an LP and injected random draws across packages
    core/      precondition, symblock, lanczos, residuals, engine, pdhg
    kernels/   hand-written CUDA kernels for the fused updates and the
               check-window megakernel, each beside its plain version
    launch/    ``python -m repro_torch.launch.solve --backend exact``
"""
__version__ = "0.1.0"
