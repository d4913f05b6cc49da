"""predictionio_tpu_torch: the PyTorch and CUDA port of predictionio_tpu.

A second package beside the JAX one, which stays the reference: each
module here mirrors the path and names of its counterpart there
(``ops/mips.py`` pairs with ``predictionio_tpu/ops/mips.py``), and the
``tests/test_torch_*.py`` files hold the two to the same outputs. The
port imports ``torch``, never ``jax`` and nothing of ``predictionio_tpu``:
what it needs from a framework-free module there it keeps as its own copy.

Every TPU kernel on a ported path is a kernel written by hand for Hopper
(``csrc/``, built at first use by ``_kernels``). Entry points run on the
card unless the caller passes ``device="cpu"``; nothing falls back.

What is ported so far: the ``train`` and ``deploy`` verbs
(``tools/cli.py``) of three templates, the recommendation template (ALS,
kernels ``csrc/als_gram.cu`` and ``csrc/mips_topk.cu``), Neural-CF
(``csrc/ncf_score.cu``) and the sequence template (SASRec,
``csrc/flash_attention.cu``); the event server and the store, continuous
learning (``online/``), the serving fabric: the micro-batched query
server, the multi-process frontend tier and hash-sharded scorer
processes (``serving/``); and evaluation (``eval/``,
``controller/metrics.py``: ``pio eval`` and ``pio eval --replay``),
``pio batchpredict`` and training observability (``obs/``: ``pio train
--profile``, structured logs, ``pio top``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
