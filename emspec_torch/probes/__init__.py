"""Measurement probes of the port (counterparts of ``bench_probes/``):
kernels that time one stage of a production kernel by stubbing the
others out.  Nothing in the pipeline calls them."""
