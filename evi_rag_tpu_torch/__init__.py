"""EVI-RAG on PyTorch and CUDA: the port of ``evi_rag_tpu`` to one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths
and function names so each counterpart is easy to find.  It imports
``torch`` and numpy only, never JAX or anything of ``evi_rag_tpu``.

What is ported so far is the serving path (``serve`` task):

* ``ops.nnfn`` / ``ops.segment`` / ``models.dde`` -- the frozen-feature
  primitives and the parameter-free DDE struct features;
* ``ops.query`` -- the plain PyTorch per-question scorer and top-k;
* ``ops.score_kernels`` -- the wrapper of the hand-written Hopper kernel
  (``csrc/per_question_topk.cu``) that replaces the Pallas kernel
  ``_per_question_topk_kernel``, with its plain PyTorch version;
* ``serving`` / ``cli`` -- the split-serving engine and the ``serve`` task.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(``utils.device.resolve_device``); with no GPU and no such request they
raise.
"""

__version__ = "0.1.0"
