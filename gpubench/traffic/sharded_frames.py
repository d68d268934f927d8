"""Sharded frames: one client renders whole frames in a closed loop, each
frame rendered by every rank of a (dp, sp) mesh, the next frame called
when the last one's resolved image is on rank 0's host.

The configuration's ``device_mesh`` gives the layout: ``dp`` contiguous
blocks of the pixels, ``sp`` interleaved shares of the samples, the scene
replicated on every rank (``parallel/sharding.py``); the world is
dp x sp ranks, one card each. This process is rank 0. Set-up starts
ranks 1 .. world - 1 as processes of their own (``torch.multiprocessing``,
spawn), each with 2 torch threads; every rank joins one process group
(NCCL on the card, gloo on the CPU; the guard bounds the wait), builds
its scene from the same arrays and its mesh, and rank 0 renders one
warm-up frame of ``warmup_spp`` passes with the others.

A frame is ``sharding.render_distributed`` on every rank: before each,
rank 0 sends every other rank the frame's (--seed, k), and each rank
draws frame k's sampler seed from them as ``frames`` does
(``vary: "sampler_seed"``). Rank 0 times each frame from its call to its
resolved image on the host. The traced run profiles two frames after
the window (see ``profile``); in the second every rank records under a
CPU-only ``torch.profiler``, so that the port's fine spans stamp, and
sends rank 0 the device ms of its ``crt.pass`` and ``crt.collective.*``
spans (``rec["ranks"]``); in the first, rank 0 counts its card's kernels
per replayed step. ``release`` has every rank leave the group at
once: NCCL's teardown waits for every rank of a communicator.

A guard thread polls the other ranks: one that dies, or a run that makes
no progress for ``HANG_S`` (a join or a collective that never ends
included), ends the process with a non-zero exit (the
other ranks killed first) when rank 0 cannot raise by itself, as it
cannot while it waits on a collective or a graph replay on the card.

The check is ``frames``'s (one frame drawn from the seed against the
plain reference, every pixel) and ``rank_film_mismatch``: the number of
ranks whose last frame's film differs, bit for bit, from rank 0's (the
ranks collect it at the end of the window and of the profiled frame).

``patch``, a key that only a test gives a cell (a picklable callable), is
called with its rank by each of ranks 1 .. world - 1 before it joins the
group: a planted fault."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch
from torch.autograd.profiler import record_function

from gpubench import cells, compare, harness, profiling, scenes, \
    span_readers

# Seconds without progress after which the guard ends the run, and the
# seconds it leaves rank 0 to raise by itself after a rank has died.
HANG_S = 110.0
DEATH_GRACE_S = 20.0
# Seconds rank 0 waits for a rank's reply.
REPLY_S = 60.0
# The span names a rank reports from its profiled frame.
RANK_SPANS = ("crt.pass", "crt.collective.sp", "crt.collective.dp")
FRAMES = cells.kind("frames")


@dataclasses.dataclass
class State:
    cell: dict
    config: dict
    device: str
    port: object
    arrays: tuple
    scene: object = None
    par: object = None
    mesh: object = None
    workers: list = dataclasses.field(default_factory=list)
    guard: object = None
    last_film: object = None
    address: str = None


def world_of(config):
    m = config["device_mesh"]
    return m["dp"], m["sp"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _view(st, seed, k, passes):
    """(camera, cfg) of frame k under --seed, with ``passes`` passes
    (None: the cell's spp)."""
    sampler_seed, _ = FRAMES.frame_params(st.cell, st.config, seed, k)
    camera, cfg = scenes.view(st.port, st.config, st.cell, None,
                              sampler_seed)
    if passes is not None:
        cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, spp=passes))
    return camera, cfg


def _join_rank(st, rank):
    """Join the group as ``rank`` and build the mesh and the scene."""
    st.par = importlib.import_module(f"{scenes.PORT}.parallel.sharding")
    world = int(np.prod(world_of(st.config)))
    st.par.init_distributed(st.address, world, rank, device_type=st.device)
    st.mesh = st.par.make_mesh(*world_of(st.config), device_type=st.device)
    st.scene = scenes.build_scene(st.port, st.config, st.arrays, st.device)


def _render(st, seed, k, passes=None):
    """This rank's film of frame k (every rank gets the whole film)."""
    camera, cfg = _view(st, seed, k, passes)
    film, sensor = st.par.render_distributed(st.scene, camera, cfg, st.mesh)
    st.last_film = film
    return film, sensor


def film_digest(film):
    """SHA-256 of a film's sums, bit for bit."""
    h = hashlib.sha256()
    for t in (film.rgb_sum, film.weight_sum):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_spans(since):
    """{name: device ms summed} of this rank's ``RANK_SPANS`` that
    started at or after host time ``since`` and carry a device time (the
    graph's last replay); {} where the port records none."""
    rec = span_readers.recorder()
    out = {}
    for s in rec.spans() if rec is not None else ():
        if (s["name"] in RANK_SPANS and s["start"] >= since
                and s["device_ms"] is not None):
            out[s["name"]] = out.get(s["name"], 0.0) + s["device_ms"]
    return out


def replay_kernels(prof):
    """(kernels, graph launches) of a profiled frame: the kernels that
    started on the card after the frame's first ``cudaGraphLaunch`` (the
    replayed steps', the collectives' included; the eager step's ended in
    the capture's synchronize), and the launches; None without one."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    launches = [ev.time_range.start for ev in events
                if ev.device_type != cuda and ev.name == "cudaGraphLaunch"]
    if not launches:
        return None
    first = min(launches)
    kernels = sum(1 for ev in events if ev.device_type == cuda
                  and ev.time_range.start >= first
                  and profiling._is_kernel(ev.name)
                  and not ev.name.startswith((profiling.RANGE_PREFIX,
                                              "nccl:")))
    return kernels, len(launches)


def _cpu_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def worker_main(rank, st, address, conn):
    """Rank ``rank`` (>= 1): join, then serve rank 0's commands until
    "stop". Nothing it writes goes to standard output, which carries rank
    0's result line."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    torch.set_num_threads(2)
    parent = os.getppid()
    threading.Thread(target=_watch_parent, args=(parent,),
                     daemon=True).start()
    patch = st.cell.get("patch")
    if patch is not None:
        patch(rank)
    st.address = address
    st.port = scenes.namespace(scenes.PORT)
    _join_rank(st, rank)
    while True:
        cmd = conn.recv()
        if cmd[0] == "frame":
            _, seed, k, passes = cmd
            _render(st, seed, k, passes)
        elif cmd[0] == "profile":
            _, seed, k = cmd
            since = time.perf_counter()
            prof = _cpu_profiler()
            _render(st, seed, k)
            prof.stop()
            conn.send(rank_spans(since))
        elif cmd[0] == "digest":
            conn.send(film_digest(st.last_film))
        elif cmd[0] == "stop":
            conn.send(harness.forbidden_modules())
            break
    st.scene = st.last_film = None
    torch.distributed.destroy_process_group()
    conn.close()


def _watch_parent(parent):
    """End this rank once rank 0's process is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(3)


class _Guard:
    """Rank 0's watch over the other ranks (see the module's docstring).
    ``beat()`` marks progress; ``stop()`` ends the watch."""

    def __init__(self, workers):
        self.workers = workers
        self.last = time.monotonic()
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def beat(self):
        self.last = time.monotonic()

    def stop(self):
        self.done.set()
        self.thread.join()

    def _run(self):
        dead_since = None
        while not self.done.wait(0.5):
            now = time.monotonic()
            dead = [r for r, (proc, _) in enumerate(self.workers, 1)
                    if not proc.is_alive()]
            if dead and dead_since is None:
                dead_since = now
            why = None
            if dead_since is not None and now - dead_since > DEATH_GRACE_S:
                codes = [self.workers[r - 1][0].exitcode for r in dead]
                why = f"rank(s) {dead} ended (exit codes {codes})"
            elif now - self.last > HANG_S:
                why = f"no progress for {HANG_S:.0f} s"
            if why is not None and not self.done.is_set():
                print(f"sharded_frames: {why}; ending the run",
                      file=sys.stderr, flush=True)
                _kill(self.workers)
                os._exit(4)


def _kill(workers):
    for proc, _ in workers:
        if proc.is_alive():
            proc.kill()


def _nccl():
    return (torch.distributed.is_initialized()
            and torch.distributed.get_backend() == "nccl")


def _abort(st):
    """After a failure on rank 0: stop the other ranks and leave the
    group. On NCCL, whose teardown waits for every rank of a
    communicator, the others are gone: the traceback is printed and the
    process ends at once, non-zero."""
    _kill(st.workers)
    if _nccl():
        traceback.print_exc()
        print("sharded_frames: a rank failed; ending the run",
              file=sys.stderr, flush=True)
        os._exit(5)
    if st.guard is not None:
        st.guard.stop()
        st.guard = None
    for proc, _ in st.workers:
        proc.join(10.0)
    st.workers = []
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _guarded(fn):
    """``fn(st, ...)`` with the other ranks stopped if it raises."""
    def run(st, *args):
        try:
            return fn(st, *args)
        except BaseException:
            _abort(st)
            raise
    run.__doc__ = fn.__doc__
    return run


def _send(st, cmd):
    for _, conn in st.workers:
        conn.send(cmd)


def _replies(st):
    """One reply from each other rank, in rank order; raises if a rank
    dies or does not reply within ``REPLY_S``."""
    out = []
    for rank, (proc, conn) in enumerate(st.workers, 1):
        deadline = time.monotonic() + REPLY_S
        while not conn.poll(0.2):
            if not proc.is_alive() or time.monotonic() > deadline:
                raise RuntimeError(f"rank {rank} gave no reply (exit code "
                                   f"{proc.exitcode})")
        out.append(conn.recv())
    return out


def _digests(st, rec):
    """Every rank's digest of its last frame's film, rank 0's first."""
    _send(st, ("digest",))
    rec["rank_digests"] = [film_digest(st.last_film)] + _replies(st)


def setup(cell, config, device):
    n_dp, n_sp = world_of(config)
    world = n_dp * n_sp
    st = State(cell, config, device, scenes.namespace(scenes.PORT),
               scenes.mesh_arrays(config))
    if device == "cuda":
        # Built once here, before the other ranks load it.
        importlib.import_module(f"{scenes.PORT}.kernels.build").build()
    st.address = f"tcp://127.0.0.1:{_free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    spec = State(cell, config, device, None, st.arrays)
    for rank in range(1, world):
        mine, theirs = ctx.Pipe()
        proc = ctx.Process(target=worker_main,
                           args=(rank, spec, st.address, theirs),
                           daemon=True)
        proc.start()
        theirs.close()
        st.workers.append((proc, mine))
    st.guard = _Guard(st.workers)
    return _guarded(_setup)(st)


def _setup(st):
    _join_rank(st, 0)
    st.guard.beat()
    render_frame(st, 0, 0, st.cell["warmup_spp"])
    st.guard.beat()
    return st


def render_frame(st, seed, k, passes=None):
    """(film, resolved image on the host) of frame k, every rank
    rendering it."""
    _send(st, ("frame", seed, k, passes))
    film, sensor = _render(st, seed, k, passes)
    with record_function(profiling.RANGE_PREFIX + "resolve"):
        image = film.resolve(sensor).cpu()
    return film, image


@_guarded
def window(st, seed, seconds, trace):
    """Frames until ``seconds`` have passed (one at least), the frame in
    flight finished; the check's frames a reservoir sample of the
    window's, drawn from the seed, as ``frames`` draws them."""
    n = st.cell.get("view", {}).get("render", {}).get(
        "spp", st.config["render"]["spp"])
    m = st.cell["check"]["frames"]
    pick = np.random.default_rng([seed, compare.CHECK_STREAM])
    frames, sample = [], []
    t_start, cpu_start = time.perf_counter(), time.process_time()
    while not frames or time.perf_counter() - t_start < seconds:
        k = len(frames)
        t_call = time.perf_counter()
        film, image = render_frame(st, seed, k)
        t_done = time.perf_counter()
        st.guard.beat()
        frames.append({"k": k, "params": FRAMES.frame_params(
            st.cell, st.config, seed, k), "t_call": t_call, "t_done": t_done,
            "samples": n * FRAMES.pixels_of(st.cell, st.config),
            "tracer": None})
        slot = k if k < m else int(pick.integers(k + 1))
        if slot < m:
            sample[slot:slot + 1] = [{"k": k, "film": film, "image": image}]
        del film, image
    if st.device == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    rec = {"frames": frames, "sample": sample, "t_start": t_start,
           "t_end": t_end, "cpu_s": time.process_time() - cpu_start,
           "passes": n, "attempted": len(frames), "failed": 0,
           "item_s": [f["t_done"] - f["t_call"] for f in frames]}
    _digests(st, rec)
    return rec


@_guarded
def profile(st, seed, rec):
    """The traced run's profiled frames, after the window, the window's
    next two. In the first, rank 0 records under the profiler of host and
    device activity (its reduced trace is returned, with the kernels of
    its replays, ``replay_kernels``; None off the card).
    In the second every rank records under a CPU-only profiler, which
    stamps the port's fine spans and leaves the device's timeline as it
    is (on four H100s, tracing the card slowed rank 0's replayed step from
    8.0 to 12.7 ms, and every other rank waited on it): the span readers
    read it, and ``rec["ranks"]`` holds each rank's device ms of its
    ``RANK_SPANS`` in its last replay, rank 0's first."""
    cuda = st.device == "cuda"
    k = len(rec["frames"])
    params = FRAMES.frame_params(st.cell, st.config, seed, k)
    out = None
    if cuda:
        torch.cuda.synchronize()
        _send(st, ("frame", seed, k, None))
        prof = profiling.start()
        t_call = time.perf_counter()
        _render(st, seed, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_call
        prof.stop()
        out = profiling.reduce(prof, wall)
        if out is not None:
            out["params"] = params
            out["replay_kernels"], out["replays"] = (
                replay_kernels(prof) or (None, 0))
    st.guard.beat()
    since = time.perf_counter()
    _send(st, ("profile", seed, k + 1))
    prof = _cpu_profiler()
    _render(st, seed, k + 1)
    prof.stop()
    rec["ranks"] = [rank_spans(since)] + _replies(st)
    st.guard.beat()
    _digests(st, rec)
    return out


def end_to_end(rec):
    return FRAMES.end_to_end(rec)


@_guarded
def release(st, rec):
    """Stop the other ranks (each reports the forbidden modules it
    loaded), every rank leaving the group at once (NCCL's teardown waits
    for every rank of a communicator), and free the program's scene. A
    forbidden module on any rank stops the run."""
    t0 = time.perf_counter()
    _send(st, ("stop",))
    found = sorted({name for names in _replies(st) for name in names})
    st.guard.beat()
    torch.distributed.destroy_process_group()
    for proc, _ in st.workers:
        proc.join(REPLY_S)
    st.guard.stop()
    st.guard = None
    _kill(st.workers)
    st.workers = []
    st.scene = st.last_film = None
    print(f"release: {time.perf_counter() - t0:.3f} s (every rank left the "
          "group)", file=sys.stderr)
    if found:
        raise harness.ForbiddenImport(
            f"loaded on another rank during the run: {', '.join(found)}")


def check(st, rec, seed, ref, ref_scene, lowered=None):
    """``frames``'s numbers (the control under ``lowered``) and
    ``rank_film_mismatch``."""
    values = FRAMES.check(st, rec, seed, ref, ref_scene, lowered)
    digests = rec["rank_digests"]
    values["rank_film_mismatch"] = sum(d != digests[0] for d in digests[1:])
    return values
