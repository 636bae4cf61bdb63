"""The data loader: the port's copies of ``phylo_hmrf_tpu/data/``
(``regions``, ``synteny``, ``contacts`` with a numpy reader, ``filters``
and ``pipeline``), numpy only."""
