"""The port's package version (copy of ``predictionio_tpu/version.py``),
the ``version`` label of the ``pio_build_info`` metric."""

__version__ = "0.1.0"
