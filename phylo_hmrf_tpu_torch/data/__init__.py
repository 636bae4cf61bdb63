"""Region grids (the port's copy of ``phylo_hmrf_tpu/data/regions.py``)."""
