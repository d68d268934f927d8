"""CUDA-graph capture and replay, under the port's hot loops
(``integrator``, ``inverse``, ``sharding``) and over the kernel wrappers of
``ops/``, whose launch counters (``LAUNCH_COUNTERS``) count where they
launch: a capture only records, so :func:`capture` takes back what it
counted and each replay of a :class:`CapturedGraph` adds it again, and the
counts read as the eager loop's. A capture's memory comes from a pool of
its own or from the card's :func:`kept_pool`."""

from __future__ import annotations

import torch

from computational_ray_tracer_tpu_torch.ops import interp_kernel as ik
from computational_ray_tracer_tpu_torch.ops import mesh_intersect_kernel as mik
from computational_ray_tracer_tpu_torch.ops import octree_kernel as okern
from computational_ray_tracer_tpu_torch.ops import rng_kernel
from computational_ray_tracer_tpu_torch.ops import shade_kernel
from computational_ray_tracer_tpu_torch.utils import metrics

# The kernel wrappers' launch counters: name -> (module, attribute).
LAUNCH_COUNTERS = {
    "brute_closest": (mik, "LAUNCHES"),
    "brute_anyhit": (mik, "LAUNCHES_ANYHIT"),
    "octree_closest": (okern, "LAUNCHES_CLOSEST"),
    "octree_anyhit": (okern, "LAUNCHES_ANYHIT"),
    "interp": (ik, "LAUNCHES"),
    "interp_backward": (ik, "LAUNCHES_BACKWARD"),
    "sampler": (rng_kernel, "LAUNCHES"),
    "shade": (shade_kernel, "LAUNCHES"),
    "shade_resolve": (shade_kernel, "LAUNCHES_RESOLVE"),
}


def launch_counts():
    """Every kernel wrapper's launch count, by LAUNCH_COUNTERS name."""
    return {key: getattr(mod, attr)
            for key, (mod, attr) in LAUNCH_COUNTERS.items()}


def add_launch_counts(counts):
    """Add ``counts`` (a launch_counts dict) to the wrappers' counters."""
    for key, n in counts.items():
        mod, attr = LAUNCH_COUNTERS[key]
        setattr(mod, attr, getattr(mod, attr) + n)


_KEPT_POOLS = {}


def kept_pool(device):
    """(pool handle, holder, stream): the memory pool of ``device``'s card
    (the current card for a device without an index), kept for the
    process, and the one stream its captures run on (:func:`capture`).

    torch frees a graph pool, on the card and in pinned host memory, once
    no graph holds it; ``holder``, a graph of one fill captured into it and
    never replayed, does. So a capture takes the blocks the last graph
    released, where a pool of its own is allocated and freed anew each time
    (on four H100s 31 ms of a rank's ~200 ms of host work a sharded frame,
    median, stalling all four ranks at once by up to half a second). The
    allocator reuses a pool's free blocks only on the stream that allocated
    them, hence one stream a pool (``torch.cuda.Stream()`` cycles through
    32)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _KEPT_POOLS:
        pool, holder = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
        with torch.cuda.device(index):
            with torch.cuda.graph(holder, pool=pool):
                torch.zeros((), device=device)
            _KEPT_POOLS[index] = pool, holder, torch.cuda.Stream()
    return _KEPT_POOLS[index]


def capture(graph, fn, pool=None):
    """``fn()`` captured into the CUDA graph ``graph``: (its output, the
    launches it counted, taken back from the counters). A failed capture
    raises. Without ``pool``, ``torch.cuda.graph``'s capture: a pool of the
    graph's own, the allocator's cache emptied. With a :func:`kept_pool`,
    the card synchronised, a capture on the pool's stream into the pool,
    the cache left as it is (so the eager work after it allocates nothing
    either)."""
    before = launch_counts()
    try:
        if pool is None:
            with torch.cuda.graph(graph):
                out = fn()
        else:
            handle, _, stream = pool
            torch.cuda.synchronize()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=handle)
                try:
                    out = fn()
                finally:
                    graph.capture_end()
    finally:
        launches = {key: n - before[key]
                    for key, n in launch_counts().items()}
        add_launch_counts({key: -n for key, n in launches.items()})
    return out, launches


class CapturedGraph:
    """``fn()`` captured as a CUDA graph (:func:`capture`, into ``pool``),
    ``out`` what the capture returned and ``launches`` what it counted;
    ``idx`` (0-d int64) and ``state`` (tensors) are static inputs of ``fn``
    that the caller made and sets before a replay. ``fn`` must have run
    once eagerly before (kernel builds, library handles, per-device
    constants, NCCL communicators)."""

    def __init__(self, fn, idx=None, state=(), pool=None):
        self.idx, self.state = idx, state
        self.graph = torch.cuda.CUDAGraph()
        self.out, self.launches = capture(self.graph, fn, pool)

    def set_index(self, sample_idx):
        """``idx`` set to ``sample_idx`` (an int or a tensor), with no read
        back to the host."""
        if isinstance(sample_idx, torch.Tensor):
            self.idx.copy_(sample_idx.reshape(()))
        else:
            self.idx.fill_(int(sample_idx))

    def replay(self, n=1):
        """Replay ``n`` times, adding the launches each time; returns
        ``out``, which the next replay overwrites."""
        for _ in range(n):
            self.graph.replay()
            add_launch_counts(self.launches)
        return self.out

    def release(self):
        """Free the graph (``CUDAGraph.reset()``), in the recorder's
        ``crt.pass.release`` span."""
        with metrics.span("crt.pass.release"):
            self.graph.reset()


def on_side_stream(fn):
    """fn() on a side stream that waits for the current one, which then
    waits for it (the warm-up of PyTorch's whole-network capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


def device_allocs(device):
    """(device allocations, device frees) the caching allocator has made on
    ``device`` (with its index) so far."""
    stats = torch.cuda.memory.memory_stats_as_nested_dict(device)
    return stats.get("num_device_alloc", 0), stats.get("num_device_free", 0)
