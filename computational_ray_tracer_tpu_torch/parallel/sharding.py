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

from computational_ray_tracer_tpu_torch.models import integrator as integ
from computational_ray_tracer_tpu_torch.ops import film as filmmod


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


def make_sharded_render(scene_template, camera, cfg, mesh):
    """A sharded progressive render step: ``step(scene, film,
    base_sample_idx) -> film`` adds n_sp sample passes (samples base ..
    base + n_sp - 1) with the pixels split over dp; every rank gets the
    whole film. Returns (step, sensor)."""
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    w, h = cfg.resolution
    lo, hi = _pixel_block(w * h, mesh)
    n_sp, sp_rank, sp_group = _axis(mesh, "sp")
    dp_group = _axis(mesh, "dp")[2]

    @torch.no_grad()
    def step(scene, film, base_sample_idx):
        pixel = torch.arange(lo, hi, device=scene.device)
        rgb, fw = integ._pass_for_pixels(scene, camera, cfg, filter_obj,
                                         sensor, pixel,
                                         int(base_sample_idx) + sp_rank)
        part = torch.cat([rgb * fw[:, None], fw[:, None]], dim=1)
        dist.all_reduce(part, group=sp_group)
        full = part.new_zeros((w * h, 4))
        full[lo:hi] = part
        dist.all_reduce(full, group=dp_group)     # the gather over dp
        return film.merge(filmmod.Film(full[:, :3].reshape(h, w, 3),
                                       full[:, 3].reshape(h, w), n_sp))

    return step, sensor


def render_distributed(scene, camera, cfg, mesh=None):
    """The sharded render: cfg.sampler.spp passes in steps of n_sp (the
    last step runs past spp when n_sp does not divide it, as the
    reference's does). The mesh defaults to every rank on dp."""
    if mesh is None:
        mesh = make_mesh(device_type=scene.device.type)
    step, sensor = make_sharded_render(scene, camera, cfg, mesh)
    film = filmmod.Film.create(cfg.resolution, device=scene.device)
    for base in range(0, cfg.sampler.spp, _axis(mesh, "sp")[0]):
        film = step(scene, film, base)
    return film, sensor


def make_train_step(scene_template, camera, cfg, mesh, param_labels,
                    optimizer=None):
    """A sharded gradient step on scene parameters against a target image
    (H, W, 3) in filter-weighted sensor RGB. ``param_labels`` is
    (extract, insert) as in ``models/inverse.py``; ``optimizer`` maps a
    list of leaf tensors to a torch optimizer (default Adam, lr 2e-2).

    Returns (train_step, init, sensor): ``init(params)`` builds the
    optimizer over the dict's leaves (tensors that require grad);
    ``train_step(params, opt_state, scene, target, sample_idx)`` renders
    sample sample_idx + sp on each rank's pixels, averages the gradients
    over every rank, leaves them in each leaf's ``.grad``, steps the
    optimizer and returns (params, opt_state, loss), the loss before the
    step."""
    _, insert = param_labels
    make_opt = optimizer or functools.partial(torch.optim.Adam, lr=2e-2)
    filter_obj = integ.make_filter(cfg)
    sensor = integ.make_sensor(cfg)
    w, h = cfg.resolution
    lo, hi = _pixel_block(w * h, mesh)
    n_dp, _, dp_group = _axis(mesh, "dp")
    n_sp, sp_rank, sp_group = _axis(mesh, "sp")

    def local_loss(params, scene, target, sample_idx):
        pixel = torch.arange(lo, hi, device=scene.device)
        rgb, fw = integ._pass_for_pixels(insert(scene, params), camera, cfg,
                                         filter_obj, sensor, pixel,
                                         int(sample_idx) + sp_rank)
        rgb_sum = dist_fn.all_reduce(rgb * fw[:, None], group=sp_group)
        wt_sum = dist_fn.all_reduce(fw, group=sp_group)
        img = rgb_sum / torch.clamp(wt_sum[:, None], min=1e-12)
        return torch.mean((img - target.reshape(-1, 3)[lo:hi]) ** 2)

    def train_step(params, opt_state, scene, target, sample_idx):
        leaves = list(params.values())
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
        return params, opt_state, loss / n_dp

    def init(params):
        return make_opt(list(params.values()))

    return train_step, init, sensor


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
