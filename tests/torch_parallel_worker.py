"""One rank of a CPU (gloo) process group for ``test_torch_parallel.py``.

    python tests/torch_parallel_worker.py '<json job>'

The job names the rank, the world size, a FileStore path (no network),
the output folder and the cases to run.  Every rank runs every case; the
first rank writes each case's whole result (gathered over the mesh) and
its collective census to ``<out>/<case>.npz``.  The settings and signals
are built here, so the test computes its references from the same ones.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from emspec_torch.config import Settings
from emspec_torch.io import synth

SR = 48_000


def settings(**kw) -> dict:
    """The JAX package's test settings (``tests/test_parallel.py``)."""
    kw.setdefault("mode", "enhanced")
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (1024, 512))
    kw.setdefault("raster_height", 128)
    kw.setdefault("hop", 256)
    return kw


def chirps(channels: int, f0: float = 150.0, f1: float = 8000.0,
           seconds: float = 1.1) -> np.ndarray:
    return np.stack([synth.chirp(f0 * (c + 1), f1, seconds, SR)
                     for c in range(channels)]).astype(np.float32)


def mono(seconds: float = 1.1) -> np.ndarray:
    return np.asarray(synth.chirp(150.0, 8000.0, seconds, SR), np.float32)


def tail_signal(world: int) -> np.ndarray:
    """t_count ≡ 3 (mod world): the last chunk is short."""
    s = Settings(**settings(smoothing=0.5, auto_gain=True))
    n_max, hop = max(s.active_fft_sizes), s.hop_samples
    t = 2 * world + 3
    n = (t - 1) * hop + n_max
    return np.asarray(synth.chirp(200.0, 6000.0, n / SR + 0.01, SR),
                      np.float32)[:n]


def cases(world: int) -> dict:
    """case → (kind, settings kwargs, signal, mesh)."""
    uneven = np.stack([(10.0 ** -c) * synth.tone(440.0, 0.3, SR)
                       for c in range(world)]).astype(np.float32)
    one = mono()
    out = {
        "pipe_enhanced": ("pipe", settings(channels=2 * world,
                                           smoothing=0.4), chirps(2 * world)),
        "pipe_agc": ("pipe", settings(channels=world, agc_global=True,
                                      auto_gain=True), uneven),
        "pipe_natural": ("pipe", settings(mode="natural", multires=False,
                                          channels=world, smoothing=0.4),
                         chirps(world)),
        "tp_enhanced": ("tp", settings(smoothing=0.4, auto_gain=True), one),
        "tp_natural": ("tp", settings(mode="natural", multires=False,
                                      smoothing=0.4, auto_gain=True), one),
        "tp_2ch_agc": ("tp", settings(channels=2, smoothing=0.4,
                                      auto_gain=True, agc_global=True),
                       np.stack([one, 2 * one])),
        "tp_tail": ("tp", settings(smoothing=0.5, auto_gain=True),
                    tail_signal(world)),
        "stream": ("stream", settings(channels=world, smoothing=0.35,
                                      agc_global=True, auto_gain=True),
                   chirps(world, f1=3000.0, seconds=0.3)),
    }
    if world == 4:
        four = np.stack([one * (c + 1) for c in range(4)])
        for mode, mr in (("enhanced", True), ("natural", False)):
            for agc in (True, False):
                out[f"grid_{mode}_{'agc' if agc else 'local'}"] = (
                    "grid", settings(mode=mode, multires=mr, channels=4,
                                     smoothing=0.4, auto_gain=True,
                                     agc_global=agc), four)
    return out


CKPT = settings(channels=4, smoothing=0.3, auto_gain=True)


def ckpt_signal() -> np.ndarray:
    return chirps(4, f0=120.0, f1=2500.0, seconds=0.3)


SPARSE = {   # hops past the largest frame (n_max 1024)
    "sparse_enhanced": settings(multires=False, fft_size=1024, hop=2048,
                                smoothing=0.4, auto_gain=True),
    "sparse_multires": settings(hop=3000, smoothing=0.4, agc_global=True,
                                auto_gain=True),
    "sparse_natural": settings(mode="natural", multires=False,
                               fft_size=1024, hop=2048, smoothing=0.4),
}


def sparse_signal(world: int) -> np.ndarray:
    return chirps(world, f0=120.0, f1=6000.0, seconds=0.5)


def _block(pipe, x, t):
    """Hop t's new samples: its window's last ``roll`` = min(hop, n_max)."""
    end = t * pipe.hop + pipe.n_max
    return x[:, end - pipe.roll:end]


def _feed(st, x, t):
    if t == 0:
        st.reset_window(x[:, :st.pipe.n_max])
    return st.step(_block(st.pipe, x, t))


def _whole(axis, a, dim):
    return torch.cat(list(axis.all_gather(a)), dim=dim)


class Rank:
    def __init__(self, job: dict):
        import torch.distributed as dist

        self.job = job
        self.world = job["world"]
        self.out = Path(job["out"])
        dist.init_process_group(
            "gloo", store=dist.FileStore(job["store"], self.world),
            rank=job["rank"], world_size=self.world)
        self.dist = dist

    def save(self, name: str, at: int, census=None, **arrays) -> None:
        """Write on the rank at coordinate ``at`` == 0 only."""
        if at == 0:
            arrays = {k: np.asarray(v) for k, v in arrays.items()}
            np.savez(self.out / f"{name}.npz",
                     census=np.asarray(json.dumps(census or {})), **arrays)

    def census(self, fn):
        from emspec_torch import parallel
        parallel.COLLECTIVES.clear()
        out = fn()
        return out, dict(parallel.COLLECTIVES)

    # ------------------------------------------------------------ cases
    def run_cases(self) -> None:
        from emspec_torch import parallel as par

        for name, (kind, kw, x) in cases(self.world).items():
            s = Settings(**kw)
            if kind == "pipe":
                sp = par.ShardedPipeline(s, par.channel_mesh(device="cpu"))
                (vis, rgba, st), census = self.census(lambda: sp.process(x))
                self.save(name, sp.axis.index, census,
                          vis=_whole(sp.axis, vis, 1),
                          rgba=_whole(sp.axis, rgba, 1),
                          smooth=_whole(sp.axis, st.smooth, 0),
                          agc_ref=_whole(sp.axis, st.agc_ref, 0),
                          shard=np.asarray(vis.shape))
            elif kind in ("tp", "grid"):
                mesh = (par.ch_time_mesh(2, device="cpu") if kind == "grid"
                        else par.channel_mesh(axis="t", device="cpu"))
                r = par.TimeParallelRenderer(s, mesh)
                (vis, rgba, st), census = self.census(lambda: r.render(x))
                t_count = r.pipe.num_columns(x.shape[-1])
                smooth, agc_ref = st.smooth, st.agc_ref
                if r.ch_axis is not None:
                    smooth = _whole(r.ch_axis, smooth, 0)
                    agc_ref = _whole(r.ch_axis, agc_ref, 0)
                index = r.axis.index + (r.ch_axis.index if r.ch_axis
                                        else 0)
                self.save(name, index, census,
                          vis=r.gather(vis, t_count),
                          rgba=r.gather(rgba, t_count),
                          smooth=smooth, agc_ref=agc_ref,
                          shard=np.asarray(vis.shape))
            else:
                mesh = par.channel_mesh(device="cpu")
                vis, rgba = par.stream_signal_sharded(x, s, mesh)
                vis_b, rgba_b, _ = par.ShardedPipeline(s, mesh).process(x)
                st = par.ShardedStream(s, mesh)
                _, step_agc = self.census(lambda: _feed(st, x, 0))
                local = par.ShardedStream(s.replace(agc_global=False), mesh)
                _, step_local = self.census(lambda: _feed(local, x, 0))
                ax = st.axis
                self.save(name, ax.index,
                          dict(step_agc=step_agc, step_local=step_local),
                          vis=vis, rgba=rgba, vis_b=_whole(ax, vis_b, 1),
                          rgba_b=_whole(ax, rgba_b, 1))

    def ckpt_save(self) -> None:
        """Save at mid-stream, then run on: the columns after the save
        are the uninterrupted reference of every resume."""
        from emspec_torch import parallel as par
        from emspec_torch.utils.checkpoint import save_sharded_stream

        x = ckpt_signal()
        a = par.ShardedStream(Settings(**CKPT), par.channel_mesh(
            device="cpu"))
        hops = a.pipe.num_columns(x.shape[-1])
        mid = hops // 2
        for t in range(mid):
            _feed(a, x, t)
        save_sharded_stream(self.out / "ck", a)
        self.save_columns("ck_ref", a, [_feed(a, x, t)
                                        for t in range(mid, hops)])

    def save_columns(self, name, st, cols) -> None:
        idx = [c[0] for c in cols if c is not None]
        vis = torch.stack([c[1] for c in cols if c is not None])
        self.save(name, st.axis.index, index=np.asarray(idx),
                  vis=_whole(st.axis, vis, 1))

    def ckpt_resume(self) -> None:
        from emspec_torch import parallel as par
        from emspec_torch.utils.checkpoint import load_sharded_stream

        x = ckpt_signal()
        b = par.ShardedStream(Settings(**CKPT), par.channel_mesh(
            device="cpu"))
        migrated = load_sharded_stream(self.out / "ck", b)
        assert migrated is False
        hops = b.pipe.num_columns(x.shape[-1])
        self.save_columns(f"ck_resume_{self.world}", b,
                          [b.step(_block(b.pipe, x, t))
                           for t in range(hops // 2, hops)])

    def sparse_hop(self) -> None:
        """``stream_signal_sharded`` at hops past n_max, then a stream
        saved at mid-stream and resumed on a fresh one (the columns after
        the save)."""
        from emspec_torch import parallel as par
        from emspec_torch.utils.checkpoint import (
            load_sharded_stream, save_sharded_stream)

        x = sparse_signal(self.world)
        for name, kw in SPARSE.items():
            s = Settings(**kw, channels=self.world)
            mesh = par.channel_mesh(device="cpu")
            vis, rgba = par.stream_signal_sharded(x, s, mesh)
            a = par.ShardedStream(s, mesh)
            hops = a.pipe.num_columns(x.shape[-1])
            for t in range(hops // 2):
                _feed(a, x, t)
            save_sharded_stream(self.out / f"{name}_ck", a)
            b = par.ShardedStream(s, mesh)
            assert load_sharded_stream(self.out / f"{name}_ck", b) is False
            cols = [b.step(_block(b.pipe, x, t))
                    for t in range(hops // 2, hops)]
            resumed = torch.stack([c[1] for c in cols if c is not None])
            self.save(name, a.axis.index, vis=vis, rgba=rgba,
                      resumed=_whole(a.axis, resumed, 1),
                      first=np.asarray(cols[0][0]))

    def migration(self) -> None:
        """``tests/test_parallel.py::
        test_sharded_checkpoint_migration_guards_step`` on this group."""
        from emspec_torch import parallel as par
        from emspec_torch.utils.checkpoint import (
            load_sharded_stream, save_sharded_stream)

        s = Settings(**settings(channels=self.world, smoothing=0.4))
        x = chirps(self.world, seconds=0.2)
        mesh = par.channel_mesh(device="cpu")
        a = par.ShardedStream(s, mesh)
        hop, n_max = a.pipe.hop, a.pipe.n_max
        hops = a.pipe.num_columns(x.shape[-1])
        mid = hops // 2
        for t in range(mid):
            _feed(a, x, t)
        ck = self.out / "mig"
        save_sharded_stream(ck, a)
        if a.axis.index == 0:     # rewrite the file without its window
            z = dict(np.load(self.out / "mig.npz", allow_pickle=False))
            n = sum(1 for k in z if k.startswith("carry_"))
            old = {k: v for k, v in z.items() if not k.startswith("carry_")}
            for i in range(1, n):
                old[f"carry_{i - 1}"] = z[f"carry_{i}"]
            np.savez(self.out / "mig.npz", **old)
        self.dist.barrier()
        res = {}
        b = par.ShardedStream(s, mesh)
        res["migrated"] = load_sharded_stream(ck, b)
        res["raises"] = _raises(lambda: b.step(_block(b.pipe, x, mid)))
        save_sharded_stream(self.out / "mig2", b)
        c = par.ShardedStream(s, mesh)
        res["guard_travels"] = load_sharded_stream(self.out / "mig2", c)
        res["raises_again"] = _raises(lambda: c.step(_block(c.pipe, x, mid)))
        b.reset_window(x[:, mid * hop: mid * hop + n_max])
        worst, same_index = 0.0, True
        for t in range(mid, hops):
            w = _block(a.pipe, x, t)
            oa, ob = a.step(w), b.step(w)
            if oa is None:
                same_index &= ob is None
                continue
            same_index &= oa[0] == ob[0]
            worst = max(worst, float((oa[1] - ob[1]).abs().max()))
        res["resumed_max_diff"] = worst
        res["same_index"] = bool(same_index)
        save_sharded_stream(self.out / "mig3", a)
        res["healthy"] = load_sharded_stream(self.out / "mig3", c)
        res["cleared"] = c.needs_window_prime
        c.step(np.zeros((s.channels, hop), np.float32))
        self.save("migration", a.axis.index, res)

    def errors(self) -> None:
        """The constructors' error texts (the test holds them to JAX's)."""
        from torch.distributed.device_mesh import DeviceMesh

        from emspec_torch import parallel as par

        res = {}
        three = Settings(**settings(channels=3))
        flat = par.channel_mesh(device="cpu")
        res["pipe"] = _message(lambda: par.ShardedPipeline(three, flat))
        res["stream"] = _message(lambda: par.ShardedStream(three, flat))
        grid = torch.arange(self.world).reshape(-1, 1)
        ab = DeviceMesh("cpu", grid, mesh_dim_names=("a", "b"))
        res["no_t"] = _message(lambda: par.TimeParallelRenderer(
            Settings(**settings(channels=2)), ab))
        cht = DeviceMesh("cpu", grid, mesh_dim_names=("ch", "t"))
        res["ch_axis"] = _message(lambda: par.TimeParallelRenderer(
            Settings(**settings(channels=3)), cht))
        r = par.TimeParallelRenderer(
            Settings(**settings(channels=self.world)), cht)
        res["mono"] = _message(lambda: r.render(np.zeros(40_000,
                                                         np.float32)))
        res["n_ch"] = _message(lambda: par.ch_time_mesh(3, device="cpu"))
        self.save("errors", flat.get_local_rank("ch"), res)


def _raises(fn) -> str:
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return ""


def _message(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def main() -> None:
    job = json.loads(sys.argv[1])
    rank = Rank(job)
    for step in job["steps"]:
        getattr(rank, step)()
    rank.dist.barrier()
    rank.dist.destroy_process_group()


if __name__ == "__main__":
    main()
