"""repro_torch: the PyTorch/CUDA port of ``repro`` (in-memory PDHG for LPs).

The JAX package ``repro`` stays the reference; this package mirrors its
subpackage layout and public names, imports ``torch`` and numpy only,
and runs on ``cuda`` unless a caller asks for ``device="cpu"``.

Ported so far:

    lp/          containers, generators, MPS I/O and the simplex (numpy
                 copies of ``repro.lp``)
    interop      carry an LP, injected random draws, crossbar state and
                 LM weights and caches across packages
    core/        precondition, symblock, lanczos, residuals, engine, pdhg
    crossbar/    the RRAM device model, encoding, arrays and solvers
    kernels/     hand-written CUDA kernels for the fused updates, the
                 megakernels and the sparse and crossbar products, each
                 beside its plain version
    runtime/     batch serving, meshes, cluster serving, sanitizers
    distributed/ the sharded solve over ``torch.distributed``
    models/      the LM substrate (ten architectures), with ``configs/``
    train/       optimizers, the train step, data, checkpoints, and the
                 serving steps (prefill, decode, greedy generation)
    launch/      ``python -m repro_torch.launch.solve``, ``.train`` and
                 ``.dryrun`` (on a fake process group)
"""
__version__ = "0.1.0"
