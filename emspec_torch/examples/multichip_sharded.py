"""Channel sharding over a device mesh: the same pipeline, channels
spread across devices, no code change — the global AGC adds the one
all-reduce.  Alone it runs at world size 1; across N cards:

    python -m emspec_torch.examples.multichip_sharded [--device cpu]
    torchrun --nproc-per-node N -m emspec_torch.examples.multichip_sharded
"""

import numpy as np
import torch
import torch.distributed as dist

from emspec_torch import Settings, ShardedPipeline, channel_mesh
from emspec_torch.examples import parse_args
from emspec_torch.io import synth


def main(argv=None) -> None:
    args = parse_args(__doc__, argv)
    mesh = channel_mesh(device=args.device)
    try:
        s = Settings(mode="enhanced", multires=True, channels=8,
                     agc_global=True)
        sp = ShardedPipeline(s, mesh)
        x = np.stack([synth.tone(220.0 * (c + 1), 0.2) for c in range(8)])
        vis, rgba, state = sp.process(x)         # this rank's channels
        whole = torch.cat(list(sp.axis.all_gather(vis)), dim=1)
        if dist.get_rank() == 0:
            print("devices:", mesh.size(), "| vis", tuple(whole.shape),
                  "| sharded over", mesh.size(), "devices")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
