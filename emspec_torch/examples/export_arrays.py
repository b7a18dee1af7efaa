"""Arrays instead of pixels: ``export`` writes the pre-LUT display values
with their physical axes, so downstream tooling (feature extraction,
pitch tracking, regression tests against other analyzers) gets numbers
carrying the full display contract — dB window, gate, AGC, smoothing —
identical to what the PNG shows (``apply_lut(vis)`` reproduces the
render pixel for pixel).

Here: export a chirp, then read the npz back and track the peak-energy
frequency over time — a 5-line "pitch tracker" over the display data.

    python -m emspec_torch.examples.export_arrays [--device cpu]
"""

import json
import tempfile
from pathlib import Path

import numpy as np

from emspec_torch.__main__ import main as cli
from emspec_torch.examples import parse_args
from emspec_torch.io import synth
from emspec_torch.io.wav import write_wav


def main(argv=None) -> None:
    args = parse_args(__doc__, argv)
    with tempfile.TemporaryDirectory(prefix="emspec_export_") as tmp:
        wav, npz = Path(tmp) / "chirp.wav", Path(tmp) / "chirp.npz"
        write_wav(wav, synth.chirp(200.0, 8000.0, 2.0), 48_000)
        # the CLI surface; library-side see
        # emspec_torch.render.raster.render_vis / Pipeline.process
        if cli(["export", str(wav), str(npz), "--multires",
                "--device", args.device]) != 0:
            raise SystemExit("export failed")
        with np.load(npz, allow_pickle=False) as z:
            vis, freq_hz, time_s = z["vis"], z["freq_hz"], z["time_s"]
            settings = json.loads(str(z["settings_json"]))
    print(f"vis {vis.shape} (rows x columns), "
          f"{freq_hz[0]:.0f}-{freq_hz[-1]:.0f} Hz, {time_s[-1]:.2f} s, "
          f"mode={settings['mode']}")

    # peak-energy ridge: for each column, the frequency of the brightest row
    ridge = freq_hz[np.argmax(vis, axis=0)]
    for frac in (0.1, 0.5, 0.9):
        c = int(frac * (len(time_s) - 1))
        print(f"  t={time_s[c]:5.2f} s  ridge={ridge[c]:7.1f} Hz")

    # the chirp rises 200 -> 8000 Hz; the ridge must rise monotonically-ish
    mid = len(ridge) // 2
    if not ridge[mid:].mean() > ridge[:mid].mean():
        raise SystemExit("the ridge does not track the chirp")
    print("ridge tracks the chirp: OK")


if __name__ == "__main__":
    main()
