"""Animated offline render: the scrolling display itself as an APNG.

Frame k is the live waterfall a viewer at ``fps`` sees at time k/fps —
driven through the real Stream → Waterfall path, so scroll-speed
semantics and emit latency are inherited and the final frame is the
``stream`` command's snapshot.

    python -m emspec_torch.examples.animate [OUT.png] [--device cpu]
"""

from emspec_torch import Settings, animate_frames, read_apng, write_apng
from emspec_torch.examples import parse_args
from emspec_torch.io import synth


def main(argv=None) -> None:
    args = parse_args(__doc__, argv, out="anim.png")
    x = synth.chirp(100.0, 8000.0, 2.0) + synth.multitone(
        [440.0, 880.0], 2.0, amplitude=0.3)
    s = Settings(mode="enhanced", multires=True, gain=5.0,
                 colormap="inferno")
    # animate_frames is a generator and write_apng compresses one frame at
    # a time — long animations never hold the raw frame stack
    write_apng(args.out, animate_frames(x, s, fps=30.0, width=1024,
                                        device=args.device), fps=30.0)
    frames, fps = read_apng(args.out)
    print(f"wrote {args.out}: {frames.shape[0]} frames {frames.shape[1:]} "
          f"@ {fps:g} fps")
    print("open it in any browser — APNG plays like the live window")


if __name__ == "__main__":
    main()
