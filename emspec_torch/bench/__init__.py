"""The port's performance harness (``emspec.bench``): timers
(``measure``), the roofline against the card's peaks (``roofline``),
throughput, latency and keep-up (``harness``), per-stage device time
(``stages``) and the leak soak (``soak``).  ``python -m emspec_torch
bench`` prints their reports."""
