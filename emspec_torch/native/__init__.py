"""The host ingest runtime (``emspec.native``): a lock-free SPSC ring,
strided framing and a WAV decoder in C++ (``src/emspec_native.cpp``),
built at first use and bound with ``ctypes`` (``lib``)."""
