"""Per-stage timing breakdown (``emspec.bench.stages``; SURVEY.md §5.5:
"per-stage μs").

Times cumulative pipeline prefixes (framing → deposits → power grid →
post chain → LUT) by the device's own time a call (``device_ms``) and
reports the differences.  Each prefix runs the routes the port resolves
on its device: the banks' frames (``_bank_inputs``: views, no device
work), B1's deposits of every bank in one id space
(``_deposit_ids_rel``) or the natural per-bank |X|², the power grid
(``_enhanced_power``: B2 over the relative histogram and its fold, or
over the absolute grid for several banks; ``_natural_power``), the batch
post chain (the fused ``post_head``, scan and ``post_tail`` on the card),
and B3 (``apply_lut``).  The JAX package's ``use_mixed_scatter`` prefix
has no counterpart: the port has no mixed scatter.
"""

from __future__ import annotations

from emspec_torch.config import MODE_ENHANCED, Settings
from emspec_torch.pipeline import Pipeline
from emspec_torch.post.chain import PostState, postprocess_batch
from emspec_torch.post.colormap import apply_lut


def stage_breakdown(settings: Settings, seconds: float = 4.0,
                    device="cuda") -> dict:
    from emspec_torch.bench.harness import _signal
    from emspec_torch.bench.measure import device_ms

    pipe = Pipeline(settings, device)
    ch = settings.channels
    x = _signal(seconds, settings.sample_rate, ch)
    t_count = pipe.num_columns(x.shape[-1])
    p = pipe.params()
    lead = (ch,) if ch > 1 else ()
    st = PostState.init(lead + (pipe.rows,), pipe.device)
    xd = pipe.to_device(x)
    enhanced = settings.mode == MODE_ENHANCED

    def upto_frames():
        return pipe._bank_inputs(xd, t_count)

    def upto_deposits():
        inputs = upto_frames()
        if enhanced:
            return pipe._deposit_ids_rel(inputs, p)
        return [pipe._bank_power(f, n) for f, n in zip(inputs, pipe.sizes)]

    def upto_power():
        if enhanced:
            return pipe._enhanced_power(xd, t_count, p)
        return pipe._natural_power(xd, t_count, p)

    def upto_post():
        cols_first = upto_power().movedim(-2, 0).contiguous()
        return postprocess_batch(cols_first, st, p.post, settings.agc_global)

    def upto_lut():
        vis, st2 = upto_post()
        return apply_lut(vis, p.lut), st2

    prefixes = {
        name: device_ms(fn, calls=10, device=pipe.device) * 1e3
        for name, fn in (("frames", upto_frames),
                         ("fft+corrections+bins", upto_deposits),
                         ("scatter(power-grid)", upto_power),
                         ("post-chain-scan", upto_post),
                         ("lut", upto_lut))}
    names = list(prefixes)
    stages = {names[0]: prefixes[names[0]]}
    for a, b in zip(names, names[1:]):
        # a difference below the timer's resolution is 0, not negative
        stages[b] = max(prefixes[b] - prefixes[a], 0.0)
    return {
        "t_count": t_count,
        "prefix_us": {k: round(v, 1) for k, v in prefixes.items()},
        "stage_us": {k: round(v, 1) for k, v in stages.items()},
    }
