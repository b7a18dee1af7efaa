"""Offline: audio in → display-ready RGBA raster out (the product
boundary).  Settings is the public API — every panel control is a field.

    python -m emspec_torch.examples.offline_render [OUT.png] [--device cpu]
"""

from emspec_torch import Settings, render
from emspec_torch.examples import parse_args
from emspec_torch.io import synth
from emspec_torch.render.png import write_png


def main(argv=None) -> None:
    args = parse_args(__doc__, argv, out="")
    x = synth.chirp(100.0, 8000.0, 2.0) + synth.multitone(
        [440.0, 880.0], 2.0, amplitude=0.3)
    img = render(x, Settings(mode="enhanced", multires=True, gain=5.0,
                             colormap="inferno"), args.device)
    print("raster:", img.shape, img.dtype)       # (rows, t, 4) uint8
    if args.out:
        write_png(args.out, img)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
