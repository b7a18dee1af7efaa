"""Real-time path: push chunks, get finalized display columns back.
Streaming output is the batch render of the same signal (the
framework's core invariant; on the CPU bit for bit).

    python -m emspec_torch.examples.streaming [--device cpu]
"""

from emspec_torch import Settings, Stream
from emspec_torch.examples import parse_args
from emspec_torch.io import synth


def main(argv=None) -> None:
    args = parse_args(__doc__, argv)
    s = Settings(mode="enhanced", multires=False, fft_size=2048)
    stream = Stream(s, args.device)
    x = synth.tone(440.0, 1.0)
    cols = []
    for i in range(0, len(x), 1024):             # arbitrary chunking
        cols += stream.push(x[i:i + 1024])
    cols += stream.flush()                        # drain the pending ring
    print(f"{len(cols)} columns; first rgba {tuple(cols[0].rgba.shape)}, "
          f"vis range [{float(cols[0].vis.min()):.3f}, "
          f"{float(cols[0].vis.max()):.3f}]")


if __name__ == "__main__":
    main()
