"""Shared inputs of the ``test_torch_train_*`` files: the same synthetic
samples (both packages' generators are the same numpy code), collated by
each package, and parameters carried from JAX into the port's module."""

import jax
import numpy as np
import torch

from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.data.synthetic import make_synthetic_dataset as j_synth
from evi_rag_tpu.models.retriever import Retriever as JRetriever
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset as t_synth
from evi_rag_tpu_torch.models.retriever import Retriever as TRetriever, load_params

EMB, HID = 32, 48
F32 = dict(rtol=1e-4, atol=1e-5)  # tests/test_serving_parity.py:67


def datasets(num_samples=8, emb_dim=EMB, max_nodes=14, seed=3):
    kw = dict(num_samples=num_samples, emb_dim=emb_dim, max_nodes=max_nodes, seed=seed)
    return j_synth(**kw), t_synth(**kw)


def batches(jds, tds, lo, hi, bucket, **kw):
    """(JAX batch, port batch) of samples [lo, hi)."""
    args = lambda ds: dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                           question_emb=ds.question_emb, bucket=bucket)
    jb = jfeed.collate_retriever(jds.samples[lo:hi], **args(jds), **kw)
    tb = tfeed.collate_retriever(tds.samples[lo:hi], **args(tds), **kw)
    return jb, tb


def models(**kw):
    """A JAX module and the port's module with the same fields."""
    kw = {"emb_dim": EMB, "hidden_dim": HID, "dropout_p": 0.0, **kw}
    return JRetriever(**kw), TRetriever(**kw)


def init_both(jmodel, tmodel, jbatch, seed=0):
    """JAX parameters (as numpy) and the port module holding the same."""
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed), jbatch))
    load_params(tmodel, params)
    return params


def grads_tree_to_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(grads_tree_to_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def to_np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
