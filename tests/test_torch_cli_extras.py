"""The CLI's start-up path in the port against the JAX CLI's: ``.env``,
``experiment=debug`` (NaN detection and deterministic mode),
``extras.platform`` and the config tree.

* ``load_dotenv`` leaves ``os.environ`` as JAX's does on the same file.
* ``experiment=debug`` on the quick synthetic ``train_retriever`` gives
  the ``metrics.json`` and checkpoint digest of the run without it, and so
  does the chain through ``eval_retriever`` to ``train_gflownet`` and
  ``serve``; the JAX CLI finishes under it too.  JAX runs in a child
  process: ``jax_debug_nans`` and ``XLA_FLAGS`` are global to a process.
* ``build`` (the gte encoder, whose model is made on the meta device
  first), ``eval_retriever``, ``eval_gflownet`` and ``sweep`` under
  ``experiment=debug`` give the outputs of their runs without extras
  (``testing.output_digest``: stores, embeddings, records, checkpoints and
  ``metrics.json`` without run times).
* A NaN learning rate raises ``FloatingPointError`` in both packages and
  neither writes ``best``.
* ``extras.platform``: ``cpu`` runs on the CPU; an unknown platform, or one
  that ``device`` contradicts, is a ``ConfigError``.
* Neither mode outlives ``main``.
* The config tree holds JAX's keys (``_`` keys left out), as a ``rich``
  tree and as the JSON line logged without ``rich``.
* The NaN mode checks NaN only: ``-inf`` top-k slots pass; the kernel
  wrappers check their own outputs and name the kernel.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _torch_build_common import write_fixture, write_tiny_gte
from bench import build_inputs, make_bundle
from evi_rag_tpu import cli as jcli
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.data import native
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.testing import output_digest
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy
from evi_rag_tpu_torch.utils import extras
from evi_rag_tpu_torch.utils.config import ConfigError, load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = str(ROOT / "configs")
# configs/experiment/quick_synthetic.yaml as overrides, so that they apply
# on top of experiment=debug (which sets max_epochs 1).
QUICK = ["dataset.num_samples=16", "dataset.max_nodes=12", "retriever.train.max_epochs=2",
         "retriever.train.k_values=[1,5,10]", "retriever.train.monitor=edge/recall@5", "gflownet.max_epochs=1",
         "gflownet.num_train_rollouts=2", "gflownet.eval_rollout_prefixes=[1,2,4]", "gflownet.eval_rollouts=4",
         "extras.print_config=false"]
NAN_LR = "retriever.train.optimizer.learning_rate=.nan"


def _modes():
    return (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, extras.nan_checks_enabled())


def _port(task, overrides, logs):
    assert tcli.main([task, "--configs-dir", CONFIGS, "device=cpu", *overrides, f"paths.log_dir={logs}"]) == 0
    (run,) = pathlib.Path(logs).glob("*/runs/*")
    return run


# --- .env -------------------------------------------------------------------

DOTENV = """
# a comment
EVI_SERVE_WINDOW_BYTES=1048576
  EVI_T_SPACED   =   padded value
EVI_T_QUOTED="quoted value"
EVI_T_EQ=a=b=c
EVI_T_EMPTY=
EVI_T_PRESET=from file
not a pair
   # indented comment
EVI_T_HASH=x#y
"""


def test_load_dotenv_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / ".env"
    path.write_text(DOTENV)
    keys = ["EVI_SERVE_WINDOW_BYTES", "EVI_T_SPACED", "EVI_T_QUOTED", "EVI_T_EQ", "EVI_T_EMPTY", "EVI_T_PRESET",
            "EVI_T_HASH", "not a pair"]
    got = {}
    for name, load in (("jax", jcli.load_dotenv), ("port", extras.load_dotenv)):
        for k in keys:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("EVI_T_PRESET", "already set")
        load(str(path))
        got[name] = {k: os.environ.get(k) for k in keys}
    assert got["port"] == got["jax"]
    assert got["port"]["EVI_T_QUOTED"] == "quoted value" and got["port"]["EVI_T_EQ"] == "a=b=c"
    assert got["port"]["EVI_T_PRESET"] == "already set" and got["port"]["EVI_T_SPACED"] == "padded value"
    extras.load_dotenv(str(tmp_path / "missing.env"))  # no file: nothing happens


def test_main_reads_dotenv_before_the_process_group(tmp_path, monkeypatch):
    """``main`` loads ``./.env`` before ``initialize_distributed``, so that
    ``.env`` can set the ``EVI_*`` variables it reads."""
    (tmp_path / ".env").write_text("EVI_T_FROM_DOTENV=yes\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("EVI_T_FROM_DOTENV", raising=False)
    seen = {}
    from evi_rag_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "initialize_distributed", lambda: seen.setdefault("v", os.environ.get(
        "EVI_T_FROM_DOTENV")))
    monkeypatch.setattr(tcli, "TASKS", {**tcli.TASKS, "seed_stats": lambda cfg, run_dir: {}})
    assert tcli.main(["seed_stats", "--configs-dir", CONFIGS, "extras.print_config=false",
                      f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    assert seen == {"v": "yes"}


# --- experiment=debug -------------------------------------------------------

def test_debug_profile_gives_the_outputs_of_the_plain_run(tmp_path):
    """train_retriever -> eval_retriever -> train_gflownet -> serve, each
    under ``experiment=debug`` and without it: the same ``metrics.json``,
    checkpoint digests and served top-k."""
    out = {}
    for name, exp in (("debug", "experiment=debug"), ("plain", "experiment=quick_synthetic")):
        w = tmp_path / name
        common = [exp, *QUICK, f"eval.artifacts_dir={w / 'art'}", f"gflownet.g_agent_dir={w / 'art' / 'g_agent'}"]
        before = _modes()
        train = _port("train_retriever", [*common, f"retriever.train.ckpt_dir={w / 'ck'}"], w / "l1")
        assert _modes() == before
        ck = w / "ck" / "best"
        for split in ("validation", "train"):
            _port("eval_retriever", [*common, f"retriever.ckpt={ck}", f"eval.splits=[{split}]",
                                     "eval.g_agent.edge_top_k=50"], w / f"l2{split}")
        gfn = _port("train_gflownet", [*common, f"retriever.ckpt={ck}", f"gflownet.ckpt_dir={w / 'gfn'}",
                                       "gflownet.hidden_dim=auto"], w / "l3")
        serve = _port("serve", [*common, f"retriever.ckpt={ck}", "serve.splits=[validation]", "serve.k=50",
                                "serve.fused_threshold=8"], w / "l4")
        out[name] = dict(
            train=json.loads((train / "metrics.json").read_text()),
            gfn=json.loads((gfn / "metrics.json").read_text()),
            gfn_state=(w / "gfn" / "best" / "state.npz").read_bytes(),
            serve=(serve / "validation_serve.jsonl").read_text(),
        )
    assert out["debug"] == out["plain"]
    assert out["debug"]["train"]["epochs"] == 2


@pytest.fixture(scope="module")
def four_inputs(tmp_path_factory):
    """What the four tasks below read, made once without extras: a
    retriever checkpoint, both splits' agent stores, a GFlowNet checkpoint,
    a raw RoG fixture and a tiny gte checkpoint."""
    w = tmp_path_factory.mktemp("four")
    common = ["experiment=quick_synthetic", *QUICK]
    _port("train_retriever", [*common, f"retriever.train.ckpt_dir={w / 'ck'}"], w / "l0")
    for split in ("train", "validation"):
        _port("eval_retriever", [*common, f"retriever.ckpt={w / 'ck' / 'best'}", f"eval.splits=[{split}]",
                                 "eval.g_agent.edge_top_k=50", f"eval.artifacts_dir={w / 'art'}"], w / f"l1{split}")
    _port("train_gflownet", [*common, f"retriever.ckpt={w / 'ck' / 'best'}", f"gflownet.ckpt_dir={w / 'gfn'}",
                             "gflownet.hidden_dim=auto", f"gflownet.g_agent_dir={w / 'art' / 'g_agent'}"], w / "l2")
    return dict(w=w, common=common, raw=write_fixture("rog", w / "raw"), gte=write_tiny_gte(w / "gte"))


def _four_task(task, inputs, out, exp):
    """``task`` with ``exp`` (the debug profile or nothing) writing under
    ``out``; returns what ``output_digest`` hashes."""
    w, common = inputs["w"], [*inputs["common"], *exp]
    if task == "build":
        run = _port("build", ["build=webqsp", f"build.raw_root={inputs['raw']}", "build.encoder.kind=gte_jax",
                              f"build.encoder.model_path={inputs['gte']}", "build.encoder.max_length=32",
                              f"build.out_dir={out / 'built'}", *exp], out / "logs")
        return out / "built", run / "metrics.json"
    if task == "eval_retriever":
        run = _port(task, [*common, f"retriever.ckpt={w / 'ck' / 'best'}", "eval.splits=[validation]",
                           "eval.g_agent.edge_top_k=50", f"eval.artifacts_dir={out / 'art'}"], out / "logs")
        return out / "art", run / "metrics.json"
    if task == "eval_gflownet":
        run = _port(task, [*common, f"gflownet.ckpt={w / 'gfn' / 'best'}", "eval.splits=[validation]",
                           f"gflownet.g_agent_dir={w / 'art' / 'g_agent'}", f"eval.artifacts_dir={out / 'art'}"],
                    out / "logs")
        return out / "art", run / "metrics.json"
    run = _port("sweep", [*common, "sweep=retriever_lr", "sweep.num_trials=2", "retriever.train.max_epochs=1"],
                out / "logs")
    return (run,)  # sweep.json, metrics.json and each trial's checkpoints and metrics


@pytest.mark.parametrize("task", ["build", "eval_retriever", "eval_gflownet", "sweep"])
def test_debug_profile_gives_the_outputs_of_the_plain_run_for(task, four_inputs, tmp_path, monkeypatch):
    """The four tasks that the chain above leaves out, each under
    ``experiment=debug`` and without extras: the same outputs."""
    monkeypatch.setattr(native, "load_library", lambda **kw: None)  # the numpy BFS engine, as the data tests
    digests = {}
    for name, exp in (("debug", ["experiment=debug"]), ("plain", [])):
        before = _modes()
        digests[name] = output_digest(*_four_task(task, four_inputs, tmp_path / name, exp))
        assert _modes() == before
    assert digests["debug"] == digests["plain"]


def test_nan_mode_skips_the_meta_device():
    """A model made on the meta device before its weights load (the gte
    encoder's ``from_state_dict``): its initialisers' outputs hold no
    values, and the mode lets them pass."""
    with extras.NanCheckMode(), torch.device("meta"):
        emb = torch.nn.Embedding(8, 4)
    assert emb.weight.is_meta


def test_nan_learning_rate_raises_in_the_port(tmp_path):
    before = _modes()
    with pytest.raises(FloatingPointError, match="extras.debug_nans: aten"):
        tcli.main(["train_retriever", "--configs-dir", CONFIGS, "experiment=debug", "device=cpu", *QUICK, NAN_LR,
                   f"retriever.train.ckpt_dir={tmp_path / 'ck'}", f"paths.log_dir={tmp_path / 'logs'}"])
    assert not (tmp_path / "ck" / "best").exists()
    assert _modes() == before


JAX_CHILD = """
import json, sys
import jax
jax.devices()  # XLA reads XLA_FLAGS once, here: the TPU flag of the debug profile comes after, as in-process
from evi_rag_tpu import cli
clean, nan = json.loads(sys.argv[1])
rc = cli.main(clean)
try:
    cli.main(nan)
    raised = None
except FloatingPointError as e:
    raised = str(e)[:200]
print(json.dumps({"rc": rc, "raised": raised, "debug_nans": jax.config.jax_debug_nans}))
"""


def test_jax_cli_under_the_debug_profile(tmp_path):
    """The JAX CLI finishes ``train_retriever experiment=debug`` (with the
    debug profile's settings as in the port test above), and a NaN learning
    rate raises ``FloatingPointError`` there without writing ``best``."""
    common = ["train_retriever", "--configs-dir", CONFIGS, "experiment=debug", *QUICK]
    runs = [[*common, f"retriever.train.ckpt_dir={tmp_path / 'ck'}", f"paths.log_dir={tmp_path / 'l1'}"],
            [*common, NAN_LR, f"retriever.train.ckpt_dir={tmp_path / 'cknan'}", f"paths.log_dir={tmp_path / 'l2'}"]]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache"),
           "PYTHONPATH": str(ROOT)}
    p = subprocess.run([sys.executable, "-c", JAX_CHILD, json.dumps(runs)], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["debug_nans"] and res["raised"] is not None, res
    assert (tmp_path / "ck" / "best").exists() and not (tmp_path / "cknan" / "best").exists()


# --- extras.platform, scope, config tree -----------------------------------

def test_platform_cpu_runs_on_the_cpu(tmp_path):
    """Without ``device=cpu`` the task would ask for the card;
    ``extras.platform=cpu`` runs it on the CPU."""
    assert tcli.main(["train_retriever", "--configs-dir", CONFIGS, "extras.platform=cpu", *QUICK,
                      "retriever.train.max_epochs=1", f"retriever.train.ckpt_dir={tmp_path / 'ck'}",
                      f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    (cfg_file,) = (tmp_path / "logs").glob("**/config.json")
    assert json.loads(cfg_file.read_text())["device"] == "cpu"
    assert (tmp_path / "ck" / "best").exists()


@pytest.mark.parametrize("overrides, match", [
    (["extras.platform=tpu"], r"extras.platform='tpu'.*\['cpu', 'cuda', 'gpu'\]"),
    (["extras.platform=cpu", "device=cuda"], "extras.platform='cpu' contradicts device='cuda'"),
    (["extras.platform=gpu", "device=cpu"], "extras.platform='gpu' contradicts device='cpu'"),
], ids=["unknown", "cpu_vs_cuda", "gpu_vs_cpu"])
def test_platform_contradictions_raise(tmp_path, overrides, match):
    with pytest.raises(ConfigError, match=match):
        tcli.main(["train_retriever", "--configs-dir", CONFIGS, *QUICK, *overrides,
                   f"paths.log_dir={tmp_path / 'logs'}"])
    assert not (tmp_path / "logs").exists()  # raised before the run dir


def test_platform_gpu_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["train_retriever", "--configs-dir", CONFIGS, *QUICK, "extras.platform=gpu",
                   f"paths.log_dir={tmp_path / 'logs'}"])


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_modes_are_scoped_to_the_task(raises):
    """``apply_extras`` holds both modes inside the block and restores the
    earlier settings on the way out, also when the task raises;
    ``CUBLAS_WORKSPACE_CONFIG`` stays set."""
    cfg = {"extras": {"deterministic": True, "debug_nans": True}}
    before = _modes()
    try:
        with extras.apply_extras(cfg):
            assert _modes() == (True, True, False, True)
            if raises:
                raise KeyError("task failed")
    except KeyError:
        assert raises
    assert _modes() == before
    extras.prepare_process(cfg)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"]


def _tree_keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _tree_keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("mode", ["json", "rich"])
def test_config_tree_holds_jax_keys(monkeypatch, capsys, mode):
    cfg = load_config(CONFIGS, "train_retriever", ["experiment=debug"])
    cfg.update(task_name="train_retriever", _configs_dir=CONFIGS)
    if mode == "json":
        monkeypatch.setitem(sys.modules, "rich", None)
        monkeypatch.setitem(sys.modules, "rich.tree", None)
        lines = {}
        for name, mod in (("jax", jcli), ("port", extras)):
            monkeypatch.setattr(mod, "log", types.SimpleNamespace(info=lambda fmt, *a, n=name: lines.setdefault(
                n, fmt % a)))
            mod.print_config_tree(cfg)
        trees = {n: json.loads(line.removeprefix("config: ")) for n, line in lines.items()}
        jax_keys = {k for k in _tree_keys(trees["jax"]) if not k.startswith("_")}
        assert _tree_keys(trees["port"]) == jax_keys
        assert "extras.debug_nans" in jax_keys
    else:
        pytest.importorskip("rich")
        jcli.print_config_tree(cfg)
        jax_out = capsys.readouterr().out
        extras.print_config_tree(cfg)
        assert capsys.readouterr().out == jax_out and "debug_nans: True" in jax_out


def test_print_config_follows_extras_print_config(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tcli, "print_config_tree", lambda cfg: calls.append(sorted(cfg)))
    monkeypatch.setattr(tcli, "TASKS", {**tcli.TASKS, "seed_stats": lambda cfg, run_dir: {}})
    for flag in ("true", "false"):
        assert tcli.main(["seed_stats", "--configs-dir", CONFIGS, f"extras.print_config={flag}",
                          f"paths.log_dir={tmp_path / flag}"]) == 0
    assert len(calls) == 1 and "_configs_dir" in calls[0]


# --- the NaN mode -----------------------------------------------------------

def test_nan_mode_forward_backward_and_inf():
    with extras.NanCheckMode():
        torch.full((3,), float("-inf")) * 2 + 1  # -inf passes
        x = torch.tensor([1.0, float("nan")])
        y = x.clone().to(torch.float64)[:1]  # copies, conversions and views are not checked
        with pytest.raises(FloatingPointError, match=r"aten\.add\.Tensor produced NaN$"):
            x + 1
        a = torch.zeros(3, requires_grad=True)
        loss = (a * 0).sqrt().sum()  # forward finite; backward inf * 0
        with pytest.raises(FloatingPointError, match=r"aten\.mul\.Tensor produced NaN \(backward of MulBackward0\)"):
            loss.backward()
    assert y.item() == 1.0 and not extras.nan_checks_enabled()


def test_serve_under_debug_nans_passes_unfilled_slots(tmp_path):
    """A plain-version serve (kernel-routed buckets through
    ``per_question_topk``'s CPU path) with k above every question's edge
    count: the unfilled slots are -inf and raise nothing."""
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint

    ck = tmp_path / "ck"
    save_checkpoint(ck, {"params": make_bundle(64, 64, 20, seed=3)["features"]},
                    meta={"parity_meta": {"dde_rounds": 2, "dde_reverse_rounds": 2}})
    runs = {}
    for name, extra in (("nans", ["extras.debug_nans=true"]), ("plain", [])):
        run = _port("serve", [f"retriever.ckpt={ck}", "dataset.num_samples=8", "dataset.max_nodes=10",
                              "serve.splits=[validation]",
                              "serve.k=64", "serve.k_values=[1,10]", "serve.fused_threshold=8",
                              "retriever.model.emb_dim=64", "dataset.emb_dim=64", "extras.print_config=false",
                              *extra], tmp_path / name)
        runs[name] = (run / "validation_serve.jsonl").read_text()
    rows = [json.loads(x) for x in runs["nans"].splitlines()]
    assert rows and all(len(r["scores"]) < 64 for r in rows)
    assert runs["nans"] == runs["plain"]


@pytest.fixture(scope="module")
def pqt_case():
    d, g, m = 64, 2, 32
    np_bundle = make_bundle(d, d, 20, seed=4)
    ins = build_inputs(g * m, d, 20, batch=g, seed=4)
    args = [torch.as_tensor(ins["q"])] + [torch.as_tensor(ins[n].reshape(g, m, -1))
                                          for n in ("head", "rel", "tail", "struct")]
    return np_bundle, args, torch.tensor([m, 5], dtype=torch.int32)


def test_kernel_plain_version_raises_on_a_planted_nan(pqt_case):
    """A NaN in one row of W1 (the inter block the kernel reads): the plain
    version of kernel 3's wrapper raises under the NaN mode, and returns
    the NaN scores without it."""
    np_bundle, args, lengths = pqt_case
    feats = {k: dict(v) if isinstance(v, dict) else v for k, v in np_bundle["features"].items()}
    w1 = feats["state_net_0"]["kernel"].copy()
    w1[3] = np.nan
    feats["state_net_0"] = {**feats["state_net_0"], "kernel": w1}
    bundle = {"features": bundle_from_numpy(feats, device="cpu")}
    vals, _ = sk.per_question_topk(bundle, *args, lengths, k=8)
    assert torch.isnan(vals).any()
    with extras.NanCheckMode(), pytest.raises(FloatingPointError, match="extras.debug_nans"):
        sk.per_question_topk(bundle, *args, lengths, k=8)


@pytest.mark.parametrize("wrapper", ["per_question_topk", "score_bidirectional", "query_topk_fused"])
def test_kernel_wrappers_check_their_outputs(monkeypatch, pqt_case, wrapper):
    """Each wrapper checks what its kernel (here its plain version, made to
    return a NaN) hands back, names the kernel, and passes -inf."""
    np_bundle, args, lengths = pqt_case
    bundle = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    out = {}

    def fake(*a, **kw):
        return out["v"] if wrapper == "score_bidirectional" else (out["v"], torch.zeros(2, 8, dtype=torch.int32))

    monkeypatch.setattr(sk, {"per_question_topk": "per_question_topk_reference",
                             "score_bidirectional": "score_bidirectional_reference",
                             "query_topk_fused": "query_topk_fused_reference"}[wrapper], fake)
    q, h, r, t, s = args
    call = {
        "per_question_topk": lambda: sk.per_question_topk(bundle, q, h, r, t, s, lengths, k=8),
        "score_bidirectional": lambda: sk.score_bidirectional(bundle, q, h[0], r[0], t[0], s[0]),
        "query_topk_fused": lambda: sk.query_topk_fused(
            bundle, q, types.SimpleNamespace(head_repr=h[0], num_candidates=h.shape[1]), k=8),
    }[wrapper]
    out["v"] = torch.full((2, 8), float("-inf"))
    with extras.NanCheckMode():
        call()
    out["v"] = torch.tensor([[0.5] * 7 + [float("nan")]] * 2)
    call()  # no mode: no check
    with extras.NanCheckMode(), pytest.raises(FloatingPointError, match=f"kernel {wrapper} produced NaN"):
        call()
