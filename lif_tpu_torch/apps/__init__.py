"""Applications over the render API (the counterpart of lif_tpu.apps)."""
