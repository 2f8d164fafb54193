"""EVI-RAG on PyTorch and CUDA: the port of ``evi_rag_tpu`` to one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module paths
and function names so each counterpart is easy to find.  It imports
``torch`` and numpy only, never JAX or anything of ``evi_rag_tpu``.

What is ported so far is the serving path (``serve`` task) and the pooled
index-and-query engine:

* ``ops.nnfn`` / ``ops.segment`` / ``models.dde`` -- the frozen-feature
  primitives and the parameter-free DDE struct features;
* ``ops.query`` -- the plain PyTorch scorers: the per-question top-k, and
  the pooled engine (``TripleIndex``, ``build_triple_index``,
  ``query_topk``, ``score_all``);
* ``ops.score_kernels`` -- the wrappers of the hand-written Hopper kernels
  that replace the three Pallas kernels (``csrc/per_question_topk.cu``,
  ``csrc/score_bidirectional.cu``, ``csrc/pooled_query.cu``, sharing
  ``csrc/twin_score.cuh``), each with its plain PyTorch version;
* ``serving`` / ``cli`` -- the split-serving engine and the ``serve`` task.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(``utils.device.resolve_device``); with no GPU and no such request they
raise.
"""

__version__ = "0.1.0"
