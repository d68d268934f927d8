"""Sharded rendering and the sharded train step over torch.distributed
(``computational_ray_tracer_tpu/parallel/sharding.py``).

One process per device (a rank). A ``DeviceMesh`` with the dims ("dp",
"sp") covers every rank of the process group:

- ``dp`` splits the pixels: the rank at dp coordinate i renders the i-th
  contiguous block of ``arange(W * H)``;
- ``sp`` splits the samples: the rank at sp coordinate j renders sample
  ``base + j``;
- the scene is replicated: every rank holds all of it (``scene_digest``
  hashes what a rank holds, to show the ranks hold the same bits);
- a render step sums rgb * w and w over sp and gathers the blocks over dp,
  so every rank returns the whole film;
- a train step's loss is the dp-mean of each rank's pixel mean of the
  squared error of the sp-summed, filter-weighted average; the sp sum is
  differentiable (its backward sums the upstream gradients over sp, n_sp
  times the local one), so the gradients averaged over every rank equal
  the unsharded loss's gradient.

Every sample is a pure function of (seed, pixel, sample, dim) and each rank
renders its pixels through ``integrator._pass_for_pixels``, the dispatch of
``render_pass``: the layout changes no sample value.

Backends: ``device_type="cuda"`` uses NCCL and raises without a card;
``"cpu"`` uses gloo. A mesh over a world of one rank starts its own process
group (an in-process store) when none is running. The dp gather is an
all_reduce of the zero-padded film: gloo takes CUDA tensors only in
all_reduce and broadcast, and so two ranks can share one card over gloo.

On NCCL the steps are the reference's one device program each:
``render_distributed`` replays a captured render step
(``integrator.capture_sums``) and ``make_train_step``'s step a captured
train step (:func:`train_graph`), each on a sample index held on the
device, with the eager steps' bits. Gloo's collectives cannot be captured, so on
gloo every step runs eagerly (``captures``). NCCL takes one rank a device.
A capture across ranks is verified on four NVIDIA H100 80GB HBM3 joined by
NVLink (NCCL 2.28.9, torch 2.11.0+cu128): ``render_distributed`` on a
(2, 2) mesh replays its step graph in lockstep on the four ranks with the
eager steps' bits, every rank holding the same film (the benchmark's
``cornell.sharded4`` cell).

``render_distributed`` keeps its step graph across calls, as ``render()``
keeps its pass: one ``integrator.KeptPass`` (the sampler seed a device
input), under ``integrator.kept_key`` with the mesh (:func:`mesh_key`). A
call with the kept key writes its seed and replays the graph for every
step; a miss runs the first step eagerly and captures a new graph in place
of the old, which it releases. The graphs live in one memory pool a card
kept for the process (``graphs.kept_pool``), so that after its first
frames a process allocates and frees no device memory. The route is the
same on every rank: each asks for one (:func:`frame_route`) and every rank
takes the last in ``ROUTES`` that any asks for (:func:`agree`), so a frame
that any rank records under a profiler captures its own graph on every
rank, released before the call returns, and leaves the kept one alone. The
kept graph goes when its scene is collected or, before NCCL tears its
communicators down, when the process group is destroyed.

A ``render_distributed`` call is the recorder's root span ``crt.frame``
(``utils/metrics.py``): its eager steps are one ``crt.pass.eager`` span,
the capture ``crt.pass.capture``, the captured step the fine ``crt.pass``,
a graph's release ``crt.pass.release``; the sp and the dp all_reduce
are the fine spans ``crt.collective.sp`` and ``crt.collective.dp``, and the
counter ``crt.collective.bytes`` holds the bytes the call all-reduces.
The counters ``crt.graph.kept`` and ``crt.graph.captured`` are 1 where it
replayed the kept graph or captured one, as in ``integrator.accumulate``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch.distributed.device_mesh import DeviceMesh

from computational_ray_tracer_tpu_torch.models import graphs
from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.models import inverse as inv
from computational_ray_tracer_tpu_torch.ops import film as filmmod
from computational_ray_tracer_tpu_torch.ops import rng_kernel
from computational_ray_tracer_tpu_torch.utils import metrics


def _backend(device_type):
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type 'cuda' needs a CUDA device and "
                               "none is available")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"unknown device type {device_type!r}")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device_type="cuda", backend=None):
    """Join a process group of ``num_processes`` ranks at
    ``coordinator_address`` (an ``init_method`` URL: ``tcp://host:port`` or
    ``file://path``) as rank ``process_id``; a no-op for one process.
    ``backend`` defaults to NCCL on "cuda" (each rank on card rank % count)
    and gloo on "cpu". Returns (world size, devices of ``device_type`` this
    process sees)."""
    if num_processes is not None and num_processes > 1:
        backend = backend or _backend(device_type)
        if device_type == "cuda":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return world, (torch.cuda.device_count() if device_type == "cuda"
                   else 1)


def make_mesh(n_dp=None, n_sp=1, device_type="cuda"):
    """A (dp, sp) DeviceMesh over every rank of the process group (dp
    defaults to world / n_sp). Raises ValueError unless n_dp * n_sp is the
    world size."""
    backend = _backend(device_type)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    n_dp = n_dp if n_dp is not None else world // n_sp
    if n_dp * n_sp != world:
        raise ValueError(
            f"mesh needs {n_dp}x{n_sp}={n_dp * n_sp} devices but the "
            f"process group has {world} ranks (one device each)")
    return DeviceMesh(device_type, torch.arange(world).reshape(n_dp, n_sp),
                      mesh_dim_names=("dp", "sp"))


def global_mesh(n_sp=1, device_type="cuda"):
    """The mesh over every rank: dp = world / n_sp."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_sp:
        raise ValueError(f"{world} devices not divisible by sp={n_sp}")
    return make_mesh(world // n_sp, n_sp, device_type)


def _axis(mesh, name):
    """(size, this rank's coordinate, process group) of mesh dim ``name``."""
    i = mesh.mesh_dim_names.index(name)
    return mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)


def _pixel_block(n_pix, mesh):
    """This rank's contiguous [lo, hi) of the flat pixel ids."""
    n_dp, dp_rank, _ = _axis(mesh, "dp")
    if n_pix % n_dp:
        raise ValueError(f"{n_pix} pixels do not split over dp={n_dp}")
    block = n_pix // n_dp
    return dp_rank * block, (dp_rank + 1) * block


def captures(mesh):
    """Whether the sharded steps on ``mesh`` replay captured CUDA graphs:
    on NCCL, whose collectives a capture records; gloo's cannot be
    captured, so on gloo every step runs eagerly. Decided from the mesh's
    backend before a step runs, never by trying a capture."""
    return dist.get_backend(_axis(mesh, "dp")[2]) == "nccl"


def _step_bytes(cfg, mesh):
    """What one render step all-reduces: the rank's block over sp and the
    zero-padded film over dp, rgb * w and w, four float32 a pixel."""
    w, h = cfg.resolution
    lo, hi = _pixel_block(w * h, mesh)
    return 16 * ((hi - lo) + w * h)


def _sharded_sums(camera, cfg, mesh, filter_obj, sensor):
    """``sums(scene, base_sample_idx)``: renders sample base + sp on this
    rank's pixels and returns what a render step adds to the film, every
    rank the whole of it: (rgb * w (H, W, 3), w (H, W)) summed over sp and
    gathered over dp. The index is a Python int or a 0-d int64 tensor on
    the scene's device (then nothing is read back to the host)."""
    w, h = cfg.resolution
    lo, hi = _pixel_block(w * h, mesh)
    sp_rank, sp_group = _axis(mesh, "sp")[1:]
    dp_group = _axis(mesh, "dp")[2]

    def sums(scene, base_sample_idx):
        pixel = torch.arange(lo, hi, device=scene.device)
        idx = integ.sample_index(base_sample_idx, scene.device) + sp_rank
        rgb, fw = integ._pass_for_pixels(scene, camera, cfg, filter_obj,
                                         sensor, pixel, idx)
        part = torch.cat([rgb * fw[:, None], fw[:, None]], dim=1)
        with metrics.fine_span("crt.collective.sp"):
            dist.all_reduce(part, group=sp_group)
        full = part.new_zeros((w * h, 4))
        full[lo:hi] = part
        with metrics.fine_span("crt.collective.dp"):
            dist.all_reduce(full, group=dp_group)     # the gather over dp
        return full[:, :3].reshape(h, w, 3), full[:, 3].reshape(h, w)

    return sums


def make_sharded_render(scene_template, camera, cfg, mesh):
    """A sharded progressive render step: ``step(scene, film,
    base_sample_idx) -> film`` adds n_sp sample passes (samples base ..
    base + n_sp - 1) with the pixels split over dp; every rank gets the
    whole film. ``base_sample_idx`` is a Python int or a 0-d int64 tensor
    on the scene's device (sp is added on the device; nothing is read
    back to the host). Every call runs eagerly. Returns (step, sensor)."""
    sensor = integ.make_sensor(cfg)
    sums = _sharded_sums(camera, cfg, mesh, integ.make_filter(cfg), sensor)
    n_sp = _axis(mesh, "sp")[0]

    @torch.no_grad()
    def step(scene, film, base_sample_idx):
        rgb, wt = sums(scene, base_sample_idx)
        return film.merge(filmmod.Film(rgb, wt, n_sp))

    return step, sensor


def mesh_key(mesh):
    """What a step graph captured on ``mesh`` depends on besides the
    scene, the camera and the config (``integrator.kept_key``'s
    ``layout``): the dims, the ranks, and this rank's group of each dim,
    by identity (the graph replays the communicators it captured)."""
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()),
            tuple(mesh.get_group(i) for i in range(mesh.ndim)))


# A frame's routes on a mesh whose steps are captured, in the order in
# which the ranks agree on one (:func:`agree`).
ROUTES = ("replay", "capture", "own")


def frame_route(key, kept_key):
    """The route this rank asks for, from its frame's key
    (``integrator.kept_key`` with :func:`mesh_key`) and the kept graph's
    (None without one):

    - "own" without a key (while a profiler records, or for a compacted
      render): an eager first step, then replays of a capture of its own,
      released before the call returns; the kept graph is left as it is;
    - "replay" where the keys are equal: every step a replay of the kept
      graph, with nothing eager and no capture;
    - "capture" otherwise: the kept graph released, an eager first step,
      then replays of a new capture, kept in its place."""
    if key is None:
        return "own"
    return "replay" if key == kept_key else "capture"


def agree(route, mesh, device):
    """The route every rank of ``mesh`` takes: the last of ``ROUTES`` that
    any of them asks for, by an all_reduce MAX over each dim's group (the
    communicators the steps use) and one read back. A profiler records on
    one rank only (the benchmark traces rank 0's card), and a rank's eager
    step against the others' replayed collectives is untried; so every
    rank captures where one records or misses."""
    flag = torch.tensor([ROUTES.index(route)], device=device)
    for i in range(mesh.ndim):
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    return ROUTES[int(flag.item())]


# The one KeptPass render_distributed holds (its step graph, in the
# card's kept pool): the last key's, or None.
_KEPT = None


def _forget(kept):
    """Drop ``kept`` if it is the kept step, and release its graph."""
    global _KEPT
    if kept is _KEPT:
        _KEPT = None
        kept.release()


def _release_before_destroy():
    """Have ``torch.distributed.destroy_process_group`` release the kept
    step graph before the groups go (wrapped once a process): NCCL tears a
    communicator down only once no CUDA graph holds its kernels, so a
    group destroyed under a kept graph would wait for ever. The scene's
    collection releases it too, whichever comes first."""
    destroy = dist.destroy_process_group
    if getattr(destroy, "releases_kept_step", False):
        return

    @functools.wraps(destroy)
    def destroy_process_group(*args, **kwargs):
        if _KEPT is not None:
            _forget(_KEPT)
        return destroy(*args, **kwargs)

    destroy_process_group.releases_kept_step = True
    dist.destroy_process_group = destroy_process_group


@torch.no_grad()
def render_distributed(scene, camera, cfg, mesh=None):
    """The sharded render: cfg.sampler.spp passes in steps of n_sp (the
    last step runs past spp when n_sp does not divide it, as the
    reference's does). The mesh defaults to every rank on dp. On gloo, or
    in one step, every step runs eagerly. On a mesh whose backend is NCCL
    (``captures``) the ranks agree on a route (:func:`frame_route`,
    :func:`agree`) and keep one step graph across calls in a
    ``integrator.KeptPass`` (the eager steps' bits of
    :func:`make_sharded_render`): a call with its key writes its seed into
    the graph's device seed and replays it for every step; a miss runs the
    first step eagerly and captures the graph it keeps. The returned film
    owns its tensors. The call is the recorder's root span ``crt.frame``
    (see the module's docstring)."""
    global _KEPT
    if mesh is None:
        mesh = make_mesh(device_type=scene.device.type)
    n_sp = _axis(mesh, "sp")[0]
    bases = range(0, cfg.sampler.spp, n_sp)
    with metrics.span("crt.frame", root=True):
        metrics.count("crt.collective.bytes",
                      len(bases) * _step_bytes(cfg, mesh))
        route = "eager"
        if captures(mesh) and len(bases) > 1:
            integ.release_held()
            key = integ.kept_key(scene, camera, cfg, scene.device,
                                 mesh_key(mesh))
            route = agree(frame_route(key, _KEPT and _KEPT.key), mesh,
                          scene.device)
        kept = _KEPT if route == "replay" else None
        if route == "capture":
            if _KEPT is not None:
                _forget(_KEPT)
            kept = integ.KeptPass(scene.device, cfg)
        if kept is not None and kept.seed is not None:
            kept.seed.fill_(rng_kernel.seed_word(cfg.sampler.seed))
        if route == "replay":
            metrics.count("crt.graph.kept", 1)
            kept.graph.set_index(0)
            rgb, wt = integ.replay_sums(kept.graph, len(bases))
            return (filmmod.Film(rgb.clone(), wt.clone(), n_sp * len(bases)),
                    kept.sensor)
        if kept is None:
            run_cfg, filter_obj = cfg, integ.make_filter(cfg)
            sensor = integ.make_sensor(cfg)
        else:
            run_cfg, filter_obj, sensor = kept.cfg, kept.filter, kept.sensor
        sums = _sharded_sums(camera, run_cfg, mesh, filter_obj, sensor)
        film = filmmod.Film.create(cfg.resolution, device=scene.device)
        with metrics.span("crt.pass.eager"):
            for base in bases if route == "eager" else bases[:1]:
                film = film.merge(filmmod.Film(*sums(scene, base), n_sp))
        if route == "eager":
            return film, sensor
        graph = integ.capture_sums(lambda idx: sums(scene, idx), n_sp, n_sp,
                                   cfg.resolution, scene.device, kept=True)
        metrics.count("crt.graph.captured", 1)
        rgb, wt = integ.replay_sums(graph, len(bases) - 1, film.rgb_sum,
                                    film.weight_sum)
        if kept is None:
            graph.release()
        else:
            kept.graph = graph
            kept.hold(scene, camera, cfg, _forget, mesh_key(mesh))
            _KEPT = kept
            _release_before_destroy()
            # the next call's replays overwrite the graph's sums
            rgb, wt = rgb.clone(), wt.clone()
        return filmmod.Film(rgb, wt, n_sp * len(bases)), sensor


def step_route(captured_backend, key, last):
    """The route of a call of :func:`make_train_step`'s step, decided
    before it runs from what it can observe. ``key`` is the call's
    (parameter names, leaves, optimizer, scene), ``last`` the previous
    call's (key, route) or None; keys are the same when the names are
    equal and the rest are the very same objects (a graph's captured
    addresses are those of its tensors).

    - "eager" unless the backend records collectives in a capture
      (``captured_backend``: NCCL) and the optimizer keeps its state on
      the device (inverse.DeviceAdam, or a torch.optim optimizer built
      with capturable=True);
    - "replay" when the last call had the same key and captured or
      replayed;
    - "capture" when the last call with it was the "warm-up";
    - "warm-up" (eager, on a side stream) otherwise: the first call, or
      one with other leaves, another optimizer or another scene, whose
      graph would replay over tensors it was not captured with. It drops
      the graph, and the next call with the same key captures anew."""
    names, leaves, opt, scene = key
    capturable = isinstance(opt, inv.DeviceAdam) or (
        isinstance(opt, torch.optim.Optimizer)
        and all(g.get("capturable", False) for g in opt.param_groups))
    if not (captured_backend and capturable):
        return "eager"
    if last is not None:
        (l_names, l_leaves, l_opt, l_scene), route = last
        if (names == l_names and len(leaves) == len(l_leaves)
                and all(a is b for a, b in zip(leaves, l_leaves))
                and opt is l_opt and scene is l_scene):
            if route in ("capture", "replay"):
                return "replay"
            if route == "warm-up":
                return "capture"
    return "warm-up"


def train_graph(eager, params, opt_state, scene, target):
    """One sharded train step captured (a ``graphs.CapturedGraph``), the
    port of the reference's jitted ``train_step``: ``eager(params,
    opt_state, scene, target, idx)`` (:func:`make_train_step`'s eager
    route) on a static target (its ``state``) and a static 0-d device index
    (its ``idx``), which the caller sets before each replay. It must have
    run once eagerly before with the same objects (the optimizer's state,
    the per-device constants, the NCCL communicators)."""
    idx = torch.zeros((), dtype=torch.int64, device=scene.device)
    static = target.detach().to(scene.device, copy=True)
    opt_state.zero_grad()
    return graphs.CapturedGraph(
        lambda: eager(params, opt_state, scene, static, idx), idx, (static,))


def make_train_step(scene_template, camera, cfg, mesh, param_labels,
                    optimizer=None):
    """A sharded gradient step on scene parameters against a target image
    (H, W, 3) in filter-weighted sensor RGB. ``param_labels`` is
    (extract, insert) as in ``models/inverse.py``; ``optimizer`` maps a
    list of leaf tensors to an optimizer with ``zero_grad`` and ``step``
    (default inverse.DeviceAdam at lr 2e-2, the reference's
    ``optax.adam(2e-2)``).

    Returns (train_step, init, sensor): ``init(params)`` builds the
    optimizer over the dict's leaves (tensors that require grad);
    ``train_step(params, opt_state, scene, target, sample_idx)`` renders
    sample sample_idx + sp on each rank's pixels, averages the gradients
    over every rank, leaves them in each leaf's ``.grad``, steps the
    optimizer and returns (params, opt_state, loss), the loss before the
    step. ``sample_idx`` is a Python int or a 0-d int64 tensor; nothing is
    read back to the host.

    Its route (:func:`step_route`; ``train_step.route`` after each
    call): on NCCL with a capturable optimizer the first call runs
    eagerly on a side stream, the second captures one :func:`train_graph`
    and every later call with the same leaves, optimizer and scene copies
    ``target`` and ``sample_idx`` into its static inputs and replays it
    (the eager route's bits; the loss returned is a copy, and the
    gradients the replay left are rebound to the leaves); other leaves,
    another optimizer or another scene start that sequence again. On gloo,
    or with another optimizer (``torch.optim.SGD`` to read the gradient),
    every call runs eagerly. ``train_step`` is a :class:`TrainStep`; its
    ``eager(params, opt_state, scene, target, sample_idx) -> loss`` is the
    eager route itself."""
    _, insert = param_labels
    make_opt = optimizer or (lambda leaves: inv.DeviceAdam(leaves, lr=2e-2))
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    w, h = cfg.resolution
    lo, hi = _pixel_block(w * h, mesh)
    n_dp, _, dp_group = _axis(mesh, "dp")
    n_sp, sp_rank, sp_group = _axis(mesh, "sp")

    def local_loss(params, scene, target, sample_idx):
        pixel = torch.arange(lo, hi, device=scene.device)
        idx = integ.sample_index(sample_idx, scene.device) + sp_rank
        rgb, fw = integ._pass_for_pixels(insert(scene, params), camera, cfg,
                                         filter_obj, sensor, pixel, idx)
        rgb_sum = dist_fn.all_reduce(rgb * fw[:, None], group=sp_group)
        wt_sum = dist_fn.all_reduce(fw, group=sp_group)
        img = rgb_sum / torch.clamp(wt_sum[:, None], min=1e-12)
        return torch.mean((img - target.reshape(-1, 3)[lo:hi]) ** 2)

    def eager(params, opt_state, scene, target, sample_idx):
        leaves = list(params.values())
        opt_state.zero_grad()
        loss = local_loss(params, scene, target, sample_idx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1) for g, p in zip(grads, leaves)])
        dist.all_reduce(flat)
        flat = flat / (n_dp * n_sp)
        for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
            p.grad = g.reshape(p.shape)
        opt_state.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=dp_group)
        return loss / n_dp

    def init(params):
        return make_opt(list(params.values()))

    return TrainStep(eager, captures(mesh)), init, sensor


class TrainStep:
    """:func:`make_train_step`'s step: ``self(params, opt_state, scene,
    target, sample_idx) -> (params, opt_state, loss)`` on the route of
    :func:`step_route`; ``route`` is the last call's, ``eager`` the eager
    route itself."""

    def __init__(self, eager, captured_backend):
        self.eager = eager
        self.captured_backend = captured_backend
        self.last = self.graph = self.grads = None

    @property
    def route(self):
        return None if self.last is None else self.last[1]

    def __call__(self, params, opt_state, scene, target, sample_idx):
        key = (tuple(params), tuple(params.values()), opt_state, scene)
        route = step_route(self.captured_backend, key, self.last)
        args = (params, opt_state, scene, target, sample_idx)
        if route == "eager":
            loss = self.eager(*args)
        elif route == "warm-up":
            self.graph = None
            loss = graphs.on_side_stream(lambda: self.eager(*args))
        else:
            if route == "capture":
                self.graph = train_graph(self.eager, *args[:4])
                self.grads = [(p, p.grad) for p in params.values()]
            self.graph.state[0].copy_(target)
            self.graph.set_index(sample_idx)
            loss = self.graph.replay().clone()
            for p, g in self.grads:
                p.grad = g
        self.last = (key, route)
        return params, opt_state, loss


def scene_digest(scene):
    """SHA-256 of every array a scene holds (tensors, the host octree, the
    packed octree), with field names, dtypes and shapes: equal digests on
    two ranks mean they hold the same bits."""
    h = hashlib.sha256()

    def visit(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous().numpy()
        if isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                h.update(f.name.encode())
                visit(getattr(x, f.name))
        else:
            h.update(repr(x).encode())

    visit(scene)
    return h.hexdigest()
