"""Multi-pod dry-run on a fake process group; the port of
``repro.launch.dryrun``.

For each (arch x shape x mesh) cell this driver:
  1. joins a fake process group (``torch.distributed`` backend "fake",
     ``FakeStore``; this process is rank 0 of 512) and builds the
     production mesh over it (``runtime.mesh.make_production_mesh``:
     16x16 single-pod / 2x16x16 multi-pod),
  2. assembles the step function (train_step / prefill / serve_step for
     LM archs; the distributed PDHG step for the paper's own LP configs),
  3. places every input as a ``meta``-device ``DTensor`` by the
     reference's specs (``partition_specs``, ``_opt_specs``,
     ``_batch_specs``, ``cache_specs``; zero allocation) -- the LP step,
     which works on this rank's blocks over explicit all-reduces, gets
     its blocks as CPU tensors, since its update kernels take CPU or
     CUDA tensors only,
  4. runs the step once under one dispatch mode (``_Costs``, a
     ``CommDebugMode``) that counts, per device, each collective's bytes
     by kind with ``launch/hlo.py``'s multipliers (all-reduce 2x output
     bytes, the others 1x), the FLOPs of every local op by
     ``torch.utils.flop_counter``'s formulas and the bytes every local
     op reads and writes, and under ``MemTracker`` for the peak of live
     bytes on this rank, and
  5. writes a JSON artifact under experiments/dryrun/.

The reference parses XLA's partitioned HLO for the same counts
(``launch/hlo.py``, not ported: there is no HLO here), scaling a loop
body's counts by its trip count.  The port's Python loops are unrolled
but for the reference's two ``lax.scan`` loops, RWKV6's token scan and
the chunked SSM's loop over chunks (``models.scan.scan``), whose bodies
run twice and are counted as their trips (``_Costs.repeated``).  The
models place their activations as the reference's sharding constraints
do (``runtime.mesh.constrain``, live under the mesh ``run_cell``
installs with ``use_mesh``).  The reference's XLA-only keys (``xla_cost``,
``compile_s``, ``lower_s``, ``hlo_estimate``) are not written;
``op_estimate`` holds the per-device FLOPs and bytes that
``hlo_estimate`` held, and ``trace_s`` the run's wall.  A cell whose
step DTensor cannot run (an op without a sharding rule) reports FAIL
with its error, and the torch it ran on, in the artifact's ``"error"``
key, as the reference's ``run_cell`` does.

The counts are DTensor's, corrected where it departs from a deployment
(``_as_deployed``: a real all-to-all, propagation left uncounted); a
torch without either hook gets no counts (FAIL).  The models pin the
placements whose collectives DTensor chose torch by torch on the cells
checked, and run rank-local work (attention, the scans, MoE routing,
the vocab-parallel embedding and loss) on each rank's blocks; torch 2.11
and 2.13 give the same peaks, FLOPs and collective bytes on the cells
``chip_smoke.py``'s phase 11 holds (PERF.md, section 7).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch lp_256k --shape dist_step
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

The fake process group is process-global: run one dry-run a process.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import (
    ARCH_NAMES,
    LP_CONFIGS,
    SHAPES,
    cell_supported,
    get_config,
    input_specs,
)
from ..models import lm as lm_mod
from ..models import scan as scan_mod
from ..runtime.mesh import dtensor_mesh, is_dtensor, make_production_mesh, \
    placements, use_mesh
from ..train.serve_step import make_prefill_step, make_serve_step
from ..train.train_step import TrainConfig, make_train_step, opt_state_shapes

# H100 SXM roofline constants (per card), from NVIDIA's H100 datasheet
PEAK_FLOPS = 989e12        # bf16 dense tensor-core rate, at 700 W
HBM_BW = 3.35e12           # B/s, HBM3
# One collective bandwidth, B/s per card: a 16x16 mesh spans 32 nodes of
# 8 cards, so the rings of both axes leave the node.  The inter-node link
# is one 400 Gb/s NDR InfiniBand port (ConnectX-7) a card, as in NVIDIA's
# DGX H100 reference design; NVLink's 450 GB/s a direction serves only
# the ranks inside a node.
NET_BW = 50e9

WORLD = 512                # fake ranks: the largest mesh's


def _fake_world(world: int = WORLD) -> None:
    """Join the fake process group as rank 0 (once a process)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


_REGISTERED = []


def _register_strategies() -> None:
    """DTensor sharding rules the models' ops need and some torch lacks
    (once a process): ``index_copy_``, the decode cache's slot write
    (``gqa_decode``, ``mla_decode``), is local to every rank when the
    written dimension is whole, with the source placed as the cache."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.index_copy_.default)
    def _index_copy(self, dim, index, source):
        dim = dim % len(self.shape)
        rules = [([Replicate()], [Replicate(), None, Replicate(),
                                  Replicate()])]
        for d in range(len(self.shape)):
            if d != dim:
                rules.append(([Shard(d)], [Shard(d), None, Replicate(),
                                           Shard(d)]))
        return rules

    _REGISTERED.append(True)


def _spec_map(fn, tree):
    """Map over a spec tree whose leaves are spec tuples."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _dp_axes(mesh, batch: int):
    """Largest data-parallel axis set that divides the global batch."""
    names = mesh.axis_names
    full = tuple(a for a in ("pod", "data") if a in names)
    size = mesh.size(full) if full else 1
    if full and batch % size == 0:
        return full
    if "data" in names and batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def _retarget_dp(spec_tree, dp):
    """Replace ('pod','data') batch axes in a spec tree with ``dp``."""
    def fix(spec):
        return tuple((dp if dp else None) if s == ("pod", "data") else s
                     for s in spec)

    return _spec_map(fix, spec_tree)


def _batch_specs(batch_sds, dp=("pod", "data")):
    specs = {}
    for k in batch_sds:
        if k in ("tokens", "labels"):
            specs[k] = (dp if dp else None, None)
        elif k == "embeddings":
            specs[k] = (dp if dp else None, None, None)
        else:
            raise ValueError(k)
    return specs


def _opt_specs(param_specs, optimizer: str = "adamw"):
    if optimizer == "adamw":
        return {"m": param_specs, "v": param_specs, "step": ()}

    # adafactor: factored second moments -- row drops the last dim,
    # col drops the second-to-last (mirrors train.optimizer.adafactor_init)
    def fac(spec):
        if len(spec) >= 2:
            return {"row": spec[:-1], "col": (*spec[:-2], spec[-1])}
        return {"v": spec}

    return {"f": _spec_map(fac, param_specs), "step": ()}


# ------------------------------------------------------------ placement ---

def _place(tree, spec_tree, mesh, dmesh, microbatches: int = 1):
    """Each ``meta`` leaf as a ``DTensor`` placed by its spec (sanitized
    to the mesh's axes).

    ``microbatches`` > 1 places a leading dimension sharded over the data
    axes as ``_StridedShard``: each rank holds its rows of every one of
    the train step's microbatches (its ``reshape(nm, b // nm, ...)``), so
    that the split is a local view with each microbatch sharded as the
    batch is.  Each rank holds as many rows as under ``Shard(0)``."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.placement_types import _StridedShard

    if isinstance(tree, dict):
        return {k: _place(v, spec_tree[k], mesh, dmesh, microbatches)
                for k, v in tree.items()}
    out = placements(mesh, spec_tree)
    if microbatches > 1:
        out = [_StridedShard(0, split_factor=microbatches)
               if p == Shard(0) else p for p in out]
    return distribute_tensor(tree, dmesh, out)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def _local_leaves(tree):
    for t in _tensors(tree):
        yield t.to_local() if is_dtensor(t) else t


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# -------------------------------------------------------------- counting ---

# launch/hlo.py's conventions: per-device bytes of each collective's
# output, all-reduce counted twice (a ring is a reduce-scatter and an
# all-gather)
_COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
}
_MULTIPLIER = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0}
# ops that move no bytes (views, metadata, allocation, a collective's wait)
_NO_IO = {"view", "_unsafe_view", "_reshape_alias", "t", "transpose",
          "permute", "expand", "squeeze", "unsqueeze", "detach", "alias",
          "slice", "select", "as_strided", "unbind", "split",
          "split_with_sizes", "unsafe_split", "diagonal", "view_as_real",
          "view_as_complex", "empty", "empty_strided", "empty_like",
          "new_empty", "new_empty_strided", "lift_fresh", "wait_tensor",
          "_wrap_tensor_autograd"}


def _costs_mode(device):
    """A ``CommDebugMode`` that also counts, for every local op this
    rank runs on ``device`` (the cell's: DTensor's sharding propagation,
    which runs on fake tensors or is marked ``_PROPAGATING``, and its
    shard bookkeeping on host index tensors excluded): its FLOPs by
    ``torch.utils.flop_counter``'s formulas, the bytes its tensors read
    and write, and each collective's bytes by kind."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import flop_registry

    class _Costs(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.io_bytes = 0.0
            self.coll_counts = {}
            self.coll_bytes = {}
            self.scale = 1          # trips of the scan body being run

        @contextlib.contextmanager
        def repeated(self, n):
            """Count what runs inside the block as ``n`` runs of it."""
            saved, self.scale = self.scale, self.scale * n
            try:
                yield
            finally:
                self.scale = saved

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            tensors = list(_local_leaves((args, kwargs or {}, out)))
            if not _rank_op(tensors, device):
                return out
            name = func._overloadpacket.__name__
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is not None:
                # the in-place c10d forms write their first argument
                b = sum(_nbytes(t) for t in _local_leaves(
                    args[0] if name.endswith("_") else out))
                self.coll_counts[kind] = (self.coll_counts.get(kind, 0)
                                          + self.scale)
                self.coll_bytes[kind] = (self.coll_bytes.get(kind, 0.0)
                                         + b * _MULTIPLIER[kind] * self.scale)
                return out
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += self.scale * formula(
                    *args, **(kwargs or {}), out_val=out)
            elif name == "mv":      # a GEMV (the LP step's products)
                self.flops += self.scale * 2.0 * args[0].numel()
            if name not in _NO_IO:
                self.io_bytes += self.scale * sum(_nbytes(t)
                                                  for t in tensors)
            return out

    return _Costs()


# > 0 while DTensor derives an op's placements (its sharding
# propagation, which runs an op's decomposition on global-shape ``meta``
# tensors on some ops and on some torches): those ops are not this rank's
_PROPAGATING = [0]


def _rank_op(tensors, device, kwargs=None) -> bool:
    """Whether an op on ``tensors`` (or a factory op told ``device=``) is
    this rank's work: on the cell's ``device`` (DTensor's shard
    bookkeeping runs on host index tensors, its propagation on fake
    tensors) and outside propagation."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor

    return (not _PROPAGATING[0] and active_fake_mode() is None
            and not any(isinstance(t, FakeTensor) for t in tensors)
            and (any(t.device == device for t in tensors)
                 or (kwargs or {}).get("device") == device))


def _hook(owner, name: str, what: str):
    """``owner.name``, the DTensor internal that a correction of
    ``_as_deployed`` replaces; a torch without it raises, naming itself
    and the hook, where the dry run would count uncorrected."""
    if not hasattr(owner, name):
        raise RuntimeError(
            f"torch {torch.__version__}: the dry run cannot correct "
            f"DTensor's {what}: {getattr(owner, '__name__', owner)!r} has "
            f"no {name!r}, so its counts cannot be vouched for")
    return getattr(owner, name)


@contextlib.contextmanager
def _as_deployed():
    """Two corrections of DTensor on the dry run's fake group, inside the
    block; each is installed or the block raises ``RuntimeError`` (never
    a count without it).  (1) DTensor redistributes a dimension's shards
    to another dimension with an all-to-all, except on a "cpu"
    DeviceMesh, where it all-gathers the whole tensor and keeps its chunk
    (gloo has no all-to-all); the dry run's mesh is "cpu" only because
    its tensors are ``meta``, and the fake group has an all-to-all, so
    the block runs one (``all_to_all_single`` of the chunks), counted and
    held in memory as the one a deployment runs: every module of DTensor
    that holds ``shard_dim_alltoall`` gets it.  (2) Sharding propagation
    is not this rank's work, and runs ops outside any fake mode (an op's
    decomposition on global-shape tensors, shard sizes on index tensors)
    where no counter can tell them from this rank's: ``_PROPAGATING``
    marks the whole of the sharding propagator's two entries, its cached
    ``propagate_op_sharding`` and ``propagate_op_sharding_non_cached``."""
    import sys

    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, _collective_utils

    gather = _hook(_collective_utils, "shard_dim_alltoall",
                   "all-gather in place of an all-to-all on a cpu mesh")
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("torch.distributed.tensor")
            and getattr(m, "shard_dim_alltoall", None) is gather]
    dispatcher = _hook(DTensor, "_op_dispatcher",
                       "sharding propagation at global shapes")
    prop = _hook(dispatcher, "sharding_propagator",
                 "sharding propagation at global shapes")
    entries = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
    for name in entries:
        _hook(prop, name, "sharding propagation at global shapes")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        # each rank's chunk of shard_dim to that rank, what comes back
        # concatenated on gather_dim: one all_to_all_single
        n = mesh.size(mesh_dim)
        send = torch.stack(torch.chunk(input, n, dim=shard_dim))
        got = funcol.all_to_all_single(send, None, None, (mesh, mesh_dim))
        if isinstance(got, funcol.AsyncCollectiveTensor):
            got = got.wait()
        return torch.cat(got.unbind(0), dim=gather_dim)

    def marked(propagate):
        def run(*a, **kw):
            _PROPAGATING[0] += 1
            try:
                return propagate(*a, **kw)
            finally:
                _PROPAGATING[0] -= 1
        return run

    saved = {name: prop.__dict__.get(name) for name in entries}
    for m in mods:
        m.shard_dim_alltoall = alltoall
    for name in entries:
        setattr(prop, name, marked(getattr(prop, name)))
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = gather
        for name, f in saved.items():
            if f is None:
                delattr(prop, name)
            else:
                setattr(prop, name, f)


def _mem_tracker(device):
    """``MemTracker`` of this rank's ops on ``device`` (``_rank_op``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class _Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(t is DTensor for t in types) and not _rank_op(
                    list(_local_leaves((args, kwargs or {}))), device,
                    kwargs):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _Tracker()


def _measure(fn, args, mesh, cfg=None, shape=None, lp=None, n_inner=None):
    """Run ``fn(*args)`` once under the counting modes: the reference's
    ``_compile_and_analyze`` for a traced step."""
    from torch.distributed.tensor.experimental import implicit_replication

    arg_leaves = list(_local_leaves(args))
    # the cell's device: "meta" for an LM cell's DTensors, the LP step's
    # host blocks for an LP cell
    device = arg_leaves[0].device
    mem = _mem_tracker(device)
    mem.track_external(*arg_leaves)
    costs = _costs_mode(device)
    t0 = time.perf_counter()
    # tensors the step makes itself (RoPE tables, masks, constants) are
    # replicated, as GSPMD treats a constant; every input stays a DTensor
    # placed by its spec
    # DTensor's corrections, where its tensors are (an LM cell's)
    deployed = _as_deployed() if any(map(is_dtensor, _tensors(args))) \
        else contextlib.nullcontext()
    with implicit_replication(), deployed, mem, costs, \
            scan_mod.counted_scans(costs):
        result = fn(*args)
    trace_s = time.perf_counter() - t0
    out_leaves = list(_local_leaves(result))
    arg_bytes = sum(_nbytes(t) for t in arg_leaves)
    out_bytes = sum(_nbytes(t) for t in out_leaves)
    # outputs written in place into an argument (the reference's donated
    # buffers): the parameters and optimizer state of a train step
    arg_storages = {a.untyped_storage()._cdata for a in arg_leaves}
    alias_bytes = sum(_nbytes(t) for t in out_leaves
                      if t.untyped_storage()._cdata in arg_storages)
    snap = mem.get_tracker_snapshot("peak")
    peak = max(v["Total"] for v in snap.values())
    n_chips = int(mesh.devices.size)
    coll_total = sum(costs.coll_bytes.values())
    out = {
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "n_chips": n_chips,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes - out_bytes + alias_bytes,
            "alias_bytes": alias_bytes,
            "peak_per_device_bytes": peak,
        },
        "op_estimate": {"flops": costs.flops, "bytes": costs.io_bytes},
        "collectives": {"counts": costs.coll_counts,
                        "bytes_by_kind": costs.coll_bytes,
                        "total_bytes": coll_total},
    }
    if cfg is not None:
        n_params = cfg.param_count()
        n_active = cfg.active_param_count()
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind != "decode" else shape.global_batch)
        mult = 6.0 if shape.kind == "train" else 2.0
        out["model"] = {
            "arch": cfg.name,
            "shape": shape.name,
            "kind": shape.kind,
            "params": n_params,
            "active_params": n_active,
            "tokens_per_step": tokens,
            "model_flops": mult * n_active * tokens,
        }
    if lp is not None:
        # 2 MVMs per PDHG iteration over the (m, n) tile grid
        out["model"] = {
            "arch": lp.name,
            "shape": f"dist_step_x{n_inner}",
            "kind": "lp",
            "model_flops": 2.0 * 2.0 * lp.m * lp.n * n_inner,
        }
    # roofline terms (seconds) on the H100 constants: per-device counts
    # over per-card rates
    flops_total = costs.flops * n_chips
    out["roofline"] = {
        "compute_s": costs.flops / PEAK_FLOPS,
        "memory_s": costs.io_bytes / HBM_BW,
        "collective_s": coll_total / NET_BW,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "collective_bw": NET_BW,
                      "source": "NVIDIA H100 SXM datasheet (bf16 dense, "
                                "HBM3); 400 Gb/s NDR InfiniBand a card "
                                "(DGX H100), the inter-node link"},
    }
    terms = out["roofline"]
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    mf = out["model"]["model_flops"]
    terms["model_flops_ratio"] = mf / flops_total if flops_total > 0 else 0.0
    return out


# ----------------------------------------------------------------- cells ---

def lower_lm_cell(arch: str, shape_name: str, mesh, sharding_mode="fsdp",
                  tcfg: TrainConfig = TrainConfig(microbatch=8),
                  cfg_overrides=None, prefill_last_only=True):
    """microbatch=8: gradient accumulation bounds activation residency
    (global 256-batch -> 32-sample microbatches); the production-memory
    default.  ``cfg_overrides`` (dict of ModelConfig fields) and
    ``prefill_last_only`` are the hillclimb knobs."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"skipped": reason}
    _register_strategies()
    dmesh = dtensor_mesh(mesh)
    params_sds = lm_mod.param_shapes(cfg)
    pspecs = lm_mod.partition_specs(cfg, mode=sharding_mode)
    params = _place(params_sds, pspecs, mesh, dmesh)
    dp = _dp_axes(mesh, shape.global_batch)
    if shape.kind == "train":
        step = make_train_step(cfg, tcfg)
        opt = _place(opt_state_shapes(params_sds, tcfg),
                     _opt_specs(pspecs, tcfg.optimizer), mesh, dmesh)
        batch_sds = input_specs(cfg, shape)
        batch = _place(batch_sds, _batch_specs(batch_sds, dp), mesh, dmesh,
                       microbatches=max(1, tcfg.microbatch))
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, last_only=prefill_last_only)
        batch_sds = input_specs(cfg, shape)
        args = (params, _place(batch_sds, _batch_specs(batch_sds, dp), mesh,
                               dmesh))
    else:  # decode
        step = make_serve_step(cfg)
        ins = input_specs(cfg, shape)
        cspecs = _retarget_dp(lm_mod.cache_specs(cfg), dp)
        args = (params, _place(ins["tokens"], (dp if dp else None, None),
                               mesh, dmesh),
                _place(ins["cache"], cspecs, mesh, dmesh))
    return _measure(step, args, mesh, cfg=cfg, shape=shape)


def lower_lp_cell(lp_name: str, mesh, n_inner: int = 64):
    from ..distributed.pdhg_dist import make_dist_step
    from ..distributed.sharding import axis_size, col_axes, padded_dim, \
        row_axes

    lpc = LP_CONFIGS[lp_name]
    Rax, Cax = row_axes(mesh), col_axes(mesh)
    R, C = axis_size(mesh, Rax), axis_size(mesh, Cax)
    m, n = padded_dim(lpc.m, R), padded_dim(lpc.n, C)
    dt = getattr(torch, lpc.dtype)
    tdt = getattr(torch, lpc.tile_dtype)
    step = make_dist_step(mesh, n_inner=n_inner)
    # this rank's blocks (the reference's specs: K over (rows, cols),
    # y-like over the row axes, x-like over the column axes)
    mb, nb = m // R, n // C

    def vec(size):
        return torch.zeros(size, dtype=dt)

    args = (torch.zeros((mb, nb), dtype=tdt),   # device-resident K tile
            vec(mb), vec(nb), vec(nb), vec(nb), vec(nb), vec(mb),
            vec(nb), vec(nb), vec(mb), torch.ones((), dtype=dt),
            torch.ones((), dtype=dt))
    return _measure(step, args, mesh, lp=lpc, n_inner=n_inner)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             sharding_mode: str = "fsdp", verbose: bool = True,
             cfg_overrides=None, prefill_last_only=True, tag_suffix="",
             tcfg=None):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}_{shape_name}_{mesh_name}{tag_suffix}"
    path = os.path.join(out_dir, f"{tag}.json")
    try:
        _fake_world()
        mesh = make_production_mesh(multi_pod=multi_pod, pods=2,
                                    backend="fake", device="cpu")
        # the models' activation constraints read the installed mesh, as
        # the reference's read the one compat.set_mesh installs
        with use_mesh(mesh):
            if arch in LP_CONFIGS:
                result = lower_lp_cell(arch, mesh)
            else:
                result = lower_lm_cell(
                    arch, shape_name, mesh, sharding_mode=sharding_mode,
                    cfg_overrides=cfg_overrides,
                    prefill_last_only=prefill_last_only,
                    **({"tcfg": tcfg} if tcfg is not None else {}))
        result["cell"] = tag
        result["sharding_mode"] = sharding_mode
        if cfg_overrides:
            result["cfg_overrides"] = cfg_overrides
        result["prefill_last_only"] = prefill_last_only
        status = "SKIP" if "skipped" in result else "OK"
    except Exception as e:  # noqa: BLE001
        # a DTensor that refuses a cell names the feature it lacks; the
        # torch it runs on is named after it
        result = {"cell": tag, "error": f"{type(e).__name__}: {e} "
                                        f"(torch {torch.__version__})",
                  "traceback": traceback.format_exc()[-2000:]}
        status = "FAIL"
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    if verbose:
        if status == "OK":
            mem = result["memory"]["peak_per_device_bytes"] / 2**30
            rf = result["roofline"]
            print(f"[{status}] {tag}: peak/dev={mem:.2f}GiB "
                  f"compute={rf['compute_s']:.3e}s "
                  f"memory={rf['memory_s']:.3e}s "
                  f"collective={rf['collective_s']:.3e}s "
                  f"bottleneck={rf['bottleneck']} "
                  f"(trace {result['trace_s']:.0f}s)", flush=True)
        elif status == "SKIP":
            print(f"[{status}] {tag}: {result['skipped']}", flush=True)
        else:
            print(f"[{status}] {tag}: {result['error']}", flush=True)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id or lp config (lp_crossbar/lp_64k/lp_256k)")
    ap.add_argument("--shape", default="train_4k",
                    help="train_4k|prefill_32k|decode_32k|long_500k|dist_step")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sharding", default="fsdp", choices=["fsdp", "dp"])
    ap.add_argument("--out", default="experiments/dryrun")
    # hillclimb knobs
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="override ModelConfig.ssm_chunk")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--prefill-naive", action="store_true",
                    help="materialize full (B,S,V) logits in prefill")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--microbatch", type=int, default=8)
    ap.add_argument("--tag-suffix", default="")
    args = ap.parse_args()
    overrides = {}
    if args.ssm_chunk is not None:
        overrides["ssm_chunk"] = args.ssm_chunk
    if args.attn_chunk is not None:
        overrides["attn_chunk"] = args.attn_chunk
    if args.kv_int8:
        overrides["kv_cache_int8"] = True

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                cells.append((arch, shape))
        for lp in LP_CONFIGS:
            cells.append((lp, "dist_step"))
    else:
        cells.append((args.arch, args.shape))
    for multi_pod in meshes:
        for arch, shape in cells:
            run_cell(arch, shape, multi_pod, args.out,
                     sharding_mode=args.sharding,
                     cfg_overrides=overrides or None,
                     prefill_last_only=not args.prefill_naive,
                     tag_suffix=args.tag_suffix,
                     tcfg=TrainConfig(optimizer=args.optimizer,
                                      microbatch=args.microbatch))


if __name__ == "__main__":
    main()
