"""Offline rendering sharded over the TIME axis: a long recording's
spectrogram spread over an N-device mesh — the other parallel seam next
to channel sharding (``multichip_sharded``).  Alone it runs at world
size 1; across N cards:

    python -m emspec_torch.examples.time_parallel_render [--device cpu]
    torchrun --nproc-per-node N -m emspec_torch.examples.time_parallel_render

Design (``emspec_torch.parallel.TimeParallelRenderer``): each device
analyzes its own column span plus a ±R frame halo (halo RECOMPUTE —
boundary deposits are regenerated locally, never communicated), and the
post chain's two constant-α EMA recurrences hand state across devices
via one all_gather of per-chunk finals + an exact affine re-basing.
"""

import numpy as np
import torch.distributed as dist

from emspec_torch import (Settings, TimeParallelRenderer, ch_time_mesh,
                          channel_mesh)
from emspec_torch.examples import parse_args
from emspec_torch.io import synth
from emspec_torch.pipeline import Pipeline


def _render_whole(r: TimeParallelRenderer, x: np.ndarray):
    """Every rank's chunk of ``r.render(x)``, gathered."""
    vis, _, _ = r.render(x)
    return r.gather(vis, r.pipe.num_columns(x.shape[-1]))


def main(argv=None) -> None:
    args = parse_args(__doc__, argv)
    dev = args.device
    s = Settings(mode="enhanced", multires=True, multires_sizes=(1024, 512),
                 raster_height=128, hop=256)
    x = np.asarray(synth.chirp(100.0, 8000.0, 2.0), np.float32)
    mesh = channel_mesh(axis="t", device=dev)
    try:
        vis = _render_whole(TimeParallelRenderer(s, mesh), x)
        vis1, _, _ = Pipeline(s, dev).process(x)
        if dist.get_rank() == 0:
            print("devices:", mesh.size(),
                  "| columns:", vis.shape[0],
                  "| sharded over", mesh.size(), "devices",
                  "| max |Δvis| vs single-device:",
                  float((vis - vis1).abs().max()))

        # ---- composed (ch × t) 2-D mesh: both seams in ONE program.  A
        # multichannel recording shards channels AND time together (the
        # offline render of the 16-channel stress configuration).  The
        # analysis stays channel-local; with global AGC the per-column
        # reference crosses the channel axis as a single all-reduce.
        s2 = s.replace(channels=2, agc_global=True)
        x2 = np.stack([x, np.asarray(synth.multitone([440.0], 2.0),
                                     np.float32)])
        n_ch = 2 if mesh.size() % 2 == 0 else 1   # 2 × N/2, or 1 × 1 alone
        mesh2 = ch_time_mesh(n_ch=n_ch, device=dev)
        vis2 = _render_whole(TimeParallelRenderer(s2, mesh2), x2)
        vis2_ref, _, _ = Pipeline(s2, dev).process(x2)
        if dist.get_rank() == 0:
            print("2-D mesh:", dict(zip(mesh2.mesh_dim_names,
                                        tuple(mesh2.mesh.shape))),
                  "| max |Δvis| vs single-device:",
                  float((vis2 - vis2_ref).abs().max()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
