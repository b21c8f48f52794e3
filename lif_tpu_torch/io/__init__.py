"""LIF file I/O: the container codec, metadata normalization and image
decode (the counterpart of lif_tpu.io)."""
