"""Multi-host serving: cluster init, per-pod bucket routing, gather;
the port of ``repro.runtime.cluster`` on ``torch.distributed``.

The paper's headline configuration is *distributed* in-memory PDHG —
crossbars tiled across many chips/pods.  ``runtime.batch`` already
serves heterogeneous LP streams bucketed and data-parallel inside one
process; this module is the step to the multi-process posture:

  * ``init_cluster`` wraps ``torch.distributed.init_process_group``
    (a ``tcp://`` rendezvous at the coordinator) behind env-driven
    auto-detection (``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``) with a
    single-process fallback, so every existing entry point keeps
    working unchanged when the env names no cluster.
  * ``route_buckets`` assigns shape buckets to pods with a
    deterministic cost model — padded FLOPs per MVM x queue depth
    (padded batch) — via longest-processing-time greedy placement.
    Every pod computes the SAME routing table from the same stream, so
    no coordination round is needed to agree on who serves what.
  * ``ClusterBatchSolver`` extends ``BatchSolver.solve_stream``: each
    pod builds and serves only its routed buckets; results cross
    pods through a shared-filesystem transport whose writes are the
    atomic-rename snapshots of ``distributed.fault`` (a torn write is
    never observed); collection is completion-order (whichever pod's
    bucket lands first is consumed first).  A straggler policy reroutes
    a dead/slow pod's pending buckets — read back from the routing
    manifest snapshot — onto the coordinator, so a killed worker never
    stalls the stream and (keys being derived from global stream
    positions) the rerouted results are bitwise-identical to the ones
    the worker would have produced.

Per-instance generator seeds depend only on ``opts.seed`` and the
instance's global position in the stream, and bucket membership/padded
batch are routing-independent -- therefore a routed stream is
bitwise-identical to the single-process ``BatchSolver.solve_stream`` on
the same device and threads (the noise streams are seeded, not timed).
The transport carries numpy arrays, so routing needs no process group.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.fault import SolverCheckpoint, load_checkpoint, \
    save_checkpoint
from .batch import BatchSolver, nnz_bucket  # noqa: F401  (re-export)

# env vars describing the cluster (REPRO_* preferred; the JAX_* spellings
# some launchers export are honored as fallbacks, as in the reference)
ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
_FALLBACK_ENV = {
    ENV_COORDINATOR: "JAX_COORDINATOR_ADDRESS",
    ENV_NUM_PROCESSES: "JAX_NUM_PROCESSES",
    ENV_PROCESS_ID: "JAX_PROCESS_ID",
}

BucketKey = Tuple[Tuple[int, int], Optional[int]]


# ---------------------------------------------------------------- init ---

@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """What ``init_cluster`` resolved: the process's place in the pod grid."""

    num_processes: int
    process_id: int
    coordinator: Optional[str]
    initialized: bool          # a process group spans the cluster (made
    #                            by this call or earlier in this process)

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


_INFO: Optional[ClusterInfo] = None


class _Teardown:
    """Leave the process group ``init_cluster`` made: a barrier, so that
    no rank leaves while another still uses the coordinator's store
    (rank 0 hosts it, and a rank whose store vanishes under its c10d
    threads aborts at exit), then ``destroy_process_group``.  Runs once;
    does nothing once the group is gone."""

    def __init__(self):
        self.done = False

    def __call__(self) -> None:
        import torch.distributed as dist

        if self.done:
            return
        self.done = True
        if not (dist.is_available() and dist.is_initialized()):
            return
        try:
            dist.barrier()
        finally:
            dist.destroy_process_group()


_TEARDOWN: Optional[_Teardown] = None


def _env(name: str) -> Optional[str]:
    v = os.environ.get(name)
    if v is None:
        v = os.environ.get(_FALLBACK_ENV.get(name, ""), None)
    return v


def detect_env() -> Optional[Dict[str, object]]:
    """The cluster the environment describes, or None (single process).

    A cluster needs all three of coordinator address, process count > 1
    and this process's id; anything partial is treated as "no cluster"
    (the single-process fallback) rather than an error, so plain local
    runs never trip on stray variables.
    """
    coord = _env(ENV_COORDINATOR)
    n = _env(ENV_NUM_PROCESSES)
    pid = _env(ENV_PROCESS_ID)
    if not coord or n is None or pid is None:
        return None
    try:
        n_i, pid_i = int(n), int(pid)
    except ValueError:           # stray/typo'd vars: no cluster, no crash
        return None
    if n_i <= 1:
        return None
    return {"coordinator_address": coord, "num_processes": n_i,
            "process_id": pid_i}


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def init_cluster(mode: str = "auto", *, backend: Optional[str] = None,
                 device=None) -> ClusterInfo:
    """Idempotent cluster bring-up with a single-process fallback.

    ``mode="auto"`` initializes the default process group
    (``init_process_group(backend, init_method="tcp://<coordinator>",
    world_size, rank)``) iff the environment describes a multi-process
    cluster (``detect_env``); ``mode="off"`` never initializes and
    reports a 1-process cluster regardless of env.  ``backend`` is
    ``"nccl"`` unless ``device`` is the CPU (then ``"gloo"``); pass
    ``"gloo"`` for several processes on one card, which NCCL refuses.
    Safe to call from every entry point -- repeat calls return the first
    resolution.  A process group made here is left at exit (``atexit``:
    a barrier, then ``destroy_process_group``), or earlier through
    ``shutdown``.
    """
    global _INFO, _TEARDOWN
    if mode not in ("auto", "off"):
        raise ValueError(f"init_cluster mode must be auto|off, got {mode!r}")
    if _INFO is not None:
        return _INFO
    if mode == "off":
        _INFO = ClusterInfo(1, 0, None, False)
        return _INFO
    spec = detect_env()
    if spec is None:
        # fallback: maybe someone else initialized the process group
        n, rank = _world()
        _INFO = ClusterInfo(n, rank, None, n > 1)
        return _INFO
    import torch.distributed as dist

    from .._device import resolve_device

    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" \
            else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{spec['coordinator_address']}",
        world_size=int(spec["num_processes"]),
        rank=int(spec["process_id"]))
    _TEARDOWN = _Teardown()
    atexit.register(_TEARDOWN)
    _INFO = ClusterInfo(int(spec["num_processes"]), int(spec["process_id"]),
                        str(spec["coordinator_address"]), True)
    return _INFO


def current_info() -> Optional[ClusterInfo]:
    return _INFO


def pod_count() -> int:
    """Pod axis granularity = process granularity (1 when single-process)."""
    if _INFO is not None:
        return max(1, _INFO.num_processes)
    return max(1, _world()[0])


def pod_id() -> int:
    if _INFO is not None:
        return _INFO.process_id
    return _world()[1]


def shutdown() -> None:
    """Run now the teardown ``init_cluster`` registered with ``atexit``
    (a barrier, then ``destroy_process_group``); nothing when this
    process made no process group or left it already."""
    if _TEARDOWN is not None:
        _TEARDOWN()


def _reset_for_tests() -> None:
    global _INFO, _TEARDOWN
    shutdown()
    _INFO = None
    _TEARDOWN = None


# ------------------------------------------------------------- routing ---

def bucket_tag(key: BucketKey) -> str:
    """Stable string id of a bucket key (filenames, routing tables)."""
    (mb, nb), sig = key
    if sig is None:
        kind = "dense"
    elif isinstance(sig, tuple):            # ("ell", wf, wa)
        kind = f"ell{sig[1]}x{sig[2]}"
    else:                                   # bare int nnz bucket
        kind = f"nnz{sig}"
    return f"{mb}x{nb}-{kind}"


def bucket_cost(key: BucketKey, queue_depth: int) -> int:
    """Deterministic serving cost: padded FLOPs per MVM x queue depth.

    Dense buckets move 2*mb*nb FLOPs per MVM; COO sparse buckets
    2*nnz_bucket (scatter contractions touch stored entries only); ELL
    buckets mb*wf + nb*wa (the two gather contractions of one fwd+adj
    MVM pair, padding slots included).  ``queue_depth`` is the padded
    batch the executable will actually run — filler slots cost real
    FLOPs, so they count.
    """
    (mb, nb), sig = key
    if sig is None:
        flops_per_mvm = 2 * mb * nb
    elif isinstance(sig, tuple):            # ("ell", wf, wa)
        flops_per_mvm = mb * sig[1] + nb * sig[2]
    else:                                   # bare int nnz bucket
        flops_per_mvm = 2 * sig
    return int(flops_per_mvm) * int(queue_depth)


def route_buckets(costs: Mapping[BucketKey, int],
                  n_pods: int) -> Dict[BucketKey, int]:
    """LPT greedy assignment of buckets to pods, fully deterministic.

    Buckets sorted by (cost desc, tag asc) go to the least-loaded pod
    (ties -> lowest pod id).  Pure function of (costs, n_pods): every
    process derives the identical table with zero communication.
    """
    n_pods = max(1, int(n_pods))
    loads = [0] * n_pods
    routing: Dict[BucketKey, int] = {}
    for key in sorted(costs, key=lambda k: (-costs[k], bucket_tag(k))):
        pod = min(range(n_pods), key=lambda p: (loads[p], p))
        routing[key] = pod
        loads[pod] += costs[key]
    return routing


# ----------------------------------------------------------- transport ---

class DirectoryTransport:
    """Shared-filesystem result plane for routed streams.

    Every write goes through ``distributed.fault.save_checkpoint`` —
    write-to-temp + atomic rename — so a reader either sees a complete
    snapshot or nothing; a pod crashing mid-publish leaves at most a
    torn ``*.tmp`` that no reader ever opens.  One subdirectory per
    stream keeps repeat ``solve_stream`` calls on a warm solver from
    colliding.  Works for localhost harnesses and for any shared mount
    (NFS/GCS-fuse) in a real pod deployment.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- paths --------------------------------------------------------
    def _stream_dir(self, stream: int) -> str:
        d = os.path.join(self.root, f"stream{stream:05d}")
        os.makedirs(d, exist_ok=True)
        return d

    def _bucket_path(self, stream: int, tag: str) -> str:
        return os.path.join(self._stream_dir(stream), f"bucket_{tag}.npz")

    def _manifest_path(self, stream: int) -> str:
        return os.path.join(self._stream_dir(stream), "manifest.npz")

    # -- manifest (routing snapshot) ----------------------------------
    def publish_manifest(self, stream: int, routing: Mapping[BucketKey, int],
                         meta: Optional[dict] = None) -> str:
        table = {bucket_tag(k): int(p) for k, p in routing.items()}
        return save_checkpoint(self._manifest_path(stream), stream, {},
                               {"routing": table, **(meta or {})})

    def fetch_manifest(self, stream: int) -> Optional[SolverCheckpoint]:
        path = self._manifest_path(stream)
        if not os.path.exists(path):
            return None
        return load_checkpoint(path)

    # -- bucket results -----------------------------------------------
    def publish_bucket(self, stream: int, tag: str, pod: int,
                       arrays: Mapping[str, np.ndarray],
                       meta: Optional[dict] = None) -> str:
        return save_checkpoint(
            self._bucket_path(stream, tag), stream, dict(arrays),
            {"pod": int(pod), "tag": tag, **(meta or {})})

    def try_fetch_bucket(self, stream: int,
                         tag: str) -> Optional[SolverCheckpoint]:
        path = self._bucket_path(stream, tag)
        if not os.path.exists(path):
            return None
        try:
            return load_checkpoint(path)
        except Exception:       # mid-rename on non-atomic mounts: retry later
            return None

    def pending_from_manifest(self, stream: int,
                              pods: Sequence[int]) -> List[str]:
        """Bucket tags routed to ``pods`` with no published result yet —
        the reroute worklist, read back from the fault.py snapshot."""
        ck = self.fetch_manifest(stream)
        if ck is None:
            return []
        return [tag for tag, pod in sorted(ck.meta["routing"].items())
                if pod in pods
                and not os.path.exists(self._bucket_path(stream, tag))]


# ------------------------------------------------------ cluster solver ---

class StragglerTimeout(RuntimeError):
    """A remote pod's buckets never arrived and this pod may not reroute."""


class ClusterBatchSolver(BatchSolver):
    """Per-pod bucket routing on top of the bucketed stream scheduler.

    Every pod runs the same ``solve_stream`` over the same stream:
    bucket grouping and the routing table are deterministic, so each pod
    independently serves exactly its routed buckets (building only
    those pipelines) and publishes per-bucket outputs through
    ``transport``.  Remote buckets are gathered completion-order; after
    ``straggler_timeout`` seconds (or immediately for *virtual* pods —
    routing targets beyond ``live_pods``, used to exercise routing
    single-process), the coordinator reroutes pending buckets onto
    itself and publishes them, so survivors still converge to the full
    result list.  Instance generator seeds derive from global stream
    positions, making routed results bitwise-identical to the
    single-process path.
    """

    def __init__(self, *args, pod: Optional[int] = None,
                 n_pods: Optional[int] = None,
                 live_pods: Optional[int] = None,
                 transport: Optional[DirectoryTransport] = None,
                 straggler_timeout: float = 60.0,
                 gather_timeout: Optional[float] = None,
                 poll_interval: float = 0.05, **kwargs):
        super().__init__(*args, **kwargs)
        self.pod = pod_id() if pod is None else int(pod)
        self.n_pods = max(1, pod_count() if n_pods is None else int(n_pods))
        self.live_pods = max(1, (pod_count() if n_pods is None else
                                 min(self.n_pods, pod_count()))
                             if live_pods is None else int(live_pods))
        self._owns_transport = False
        if transport is None and self.n_pods > 1:
            tdir = os.environ.get("REPRO_TRANSPORT_DIR")
            if tdir:
                transport = DirectoryTransport(tdir)
            elif pod_count() > 1:
                # a private mkdtemp per process would mean pods silently
                # never see each other's results — fail loudly instead
                raise RuntimeError(
                    "multi-process cluster serving needs a SHARED result "
                    "plane: set REPRO_TRANSPORT_DIR to a directory every "
                    "pod can reach, or pass transport= explicitly")
            else:
                # single-process virtual pods: private scratch, cleaned
                # up per stream (nobody else ever reads it)
                transport = DirectoryTransport(
                    tempfile.mkdtemp(prefix="repro-cluster-"))
                self._owns_transport = True
        self.transport = transport
        self.straggler_timeout = float(straggler_timeout)
        self.gather_timeout = (4.0 * self.straggler_timeout
                               if gather_timeout is None
                               else float(gather_timeout))
        self.poll_interval = float(poll_interval)
        self.stream_seq = 0          # per-solver stream counter; every pod
        #                              sees the same call sequence
        self.last_routing: Dict[str, int] = {}
        self.last_costs: Dict[str, int] = {}
        self.last_bucket_sizes: Dict[str, int] = {}

    # -- routing ------------------------------------------------------

    def _route(self, buckets):
        # audit surface: the table/costs/sizes the routing actually used
        # (benchmarks and dashboards read these instead of re-deriving)
        self.last_costs = {bucket_tag(k): bucket_cost(
            k, self._padded_batch(len(idxs)))
            for k, idxs in buckets.items()}
        self.last_bucket_sizes = {bucket_tag(k): len(idxs)
                                  for k, idxs in buckets.items()}
        if self.n_pods == 1:
            self.last_routing = {bucket_tag(k): 0 for k in buckets}
            return dict(buckets), {}
        costs = {k: bucket_cost(k, self._padded_batch(len(idxs)))
                 for k, idxs in buckets.items()}
        routing = route_buckets(costs, self.n_pods)
        self.last_routing = {bucket_tag(k): p for k, p in routing.items()}
        if self.pod == 0:
            # the fault.py snapshot reroutes read pending work from
            self.transport.publish_manifest(
                self.stream_seq, routing,
                {"n_pods": self.n_pods, "live_pods": self.live_pods})
        mine = {k: v for k, v in buckets.items() if routing[k] == self.pod}
        remote = {k: v for k, v in buckets.items() if routing[k] != self.pod}
        self._remote_routing = routing
        return mine, remote

    # -- publish ------------------------------------------------------

    def _bucket_served(self, key: BucketKey, idxs, out) -> None:
        if self.n_pods == 1:
            return
        xs, ys, its, merits = (o.cpu().numpy() for o in out[:4])
        arrays = {"xs": xs, "ys": ys, "its": its, "merits": merits}
        if len(out) > 4:
            # raw norm estimates (5-tuple pipelines); remote consumers
            # feed them into their own norm-reuse cache on fetch
            arrays["rhos"] = out[4].cpu().numpy()
        self.transport.publish_bucket(
            self.stream_seq, bucket_tag(key), self.pod, arrays,
            {"idxs": list(int(i) for i in idxs)})

    # -- gather + straggler policy ------------------------------------

    def _reroute_buckets(self, pairs, lps, results, stats):
        """Serve straggler pods' buckets locally and publish them (same
        pipelines, same global-position seeds -> identical outputs),
        dispatch-then-collect like the base scheduler (``_serve``)."""
        if not pairs:
            return
        self._serve(dict(pairs), lps, results, stats, self._draws)
        stats["rerouted_buckets"] += len(pairs)

    def _gather_remote(self, remote, lps, results, stats) -> None:
        stats["routing"] = dict(self.last_routing)
        stats["pod"] = self.pod
        stats["n_pods"] = self.n_pods
        stats["rerouted_buckets"] = stats.get("rerouted_buckets", 0)
        stats["gather_s"] = 0.0
        if not remote:
            return
        t0 = time.perf_counter()
        pending = dict(remote)
        # virtual pods (routing targets with no live process) never
        # publish: the coordinator serves their buckets immediately
        if self.pod == 0:
            virtual = [(k, pending.pop(k)) for k in list(pending)
                       if self._remote_routing[k] >= self.live_pods]
            self._reroute_buckets(virtual, lps, results, stats)
        deadline = time.perf_counter() + self.straggler_timeout
        hard_deadline = time.perf_counter() + self.gather_timeout
        while pending:
            progress = False
            for key in sorted(pending, key=bucket_tag):
                ck = self.transport.try_fetch_bucket(self.stream_seq,
                                                     bucket_tag(key))
                if ck is None:
                    continue
                idxs = pending.pop(key)
                names = ("xs", "ys", "its", "merits", "rhos")
                out = tuple(torch.as_tensor(ck.arrays[k]) for k in names
                            if k in ck.arrays)
                self._collect(out, key[0], idxs, lps, results)
                progress = True
            if progress:
                # a live-but-slow pod that keeps publishing is never a
                # straggler: the reroute deadline measures silence, so
                # its work is not duplicated while it makes progress
                deadline = time.perf_counter() + self.straggler_timeout
            if not pending:
                break
            if self.pod == 0 and time.perf_counter() > deadline:
                # straggler policy: whatever the manifest still shows as
                # unpublished gets rerouted onto the coordinator
                stalled = set(self.transport.pending_from_manifest(
                    self.stream_seq,
                    [p for p in range(self.n_pods) if p != self.pod]))
                hit = [(k, pending.pop(k))
                       for k in sorted(pending, key=bucket_tag)
                       if bucket_tag(k) in stalled]
                self._reroute_buckets(hit, lps, results, stats)
                progress = progress or bool(hit)
            if pending and time.perf_counter() > hard_deadline:
                # reachable even past the straggler deadline (e.g. a
                # bucket file that exists but never becomes readable)
                raise StragglerTimeout(
                    f"pod {self.pod}: buckets "
                    f"{[bucket_tag(k) for k in pending]} never arrived "
                    f"within {self.gather_timeout}s")
            if pending and not progress:
                time.sleep(self.poll_interval)
        stats["gather_s"] = time.perf_counter() - t0

    def solve_stream(self, lps, draws=None):
        try:
            return super().solve_stream(lps, draws)
        finally:
            if self._owns_transport:
                # private single-process scratch: nobody else ever reads
                # it, so don't let repeat streams accumulate on disk
                import shutil
                shutil.rmtree(self.transport._stream_dir(self.stream_seq),
                              ignore_errors=True)
            self.stream_seq += 1
