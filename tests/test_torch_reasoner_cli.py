"""Port vs JAX: the ``reasoner`` CLI task on one small agent store.

Both packages' ``python -m ... reasoner`` read the same g_agent store and
the same BFS chains and must write equal ``metrics.json`` and equal
prediction records, in oracle mode, mock-LLM mode over triplets and
mock-LLM mode over paths.  Both see a stand-in ``tiktoken`` whose lookup
fails (the offline rule, ``len // 4``), so that no test reaches for the
encoding file.  The port's task then runs against a stub ``/api/chat``
server on 127.0.0.1 (``reasoner=ollama``), a transient 500 included.
"""

import json
import pathlib
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from evi_rag_tpu import cli as jcli
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.eval import prompting as tprompting
from evi_rag_tpu_torch.eval.artifacts import save_agent_store
from tests.test_torch_reasoner import _agent_samples, _fake_tiktoken

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
MOCK = '{"answers": ["101", "ent 102"]}'


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A validation agent store (written by the port, byte-equal to JAX's)
    and its BFS chains (the port's ``bfs_chains``)."""
    root = tmp_path_factory.mktemp("reasoner_store")
    _, samples = _agent_samples(n=4, seed=5)
    save_agent_store(samples, root / "art" / "g_agent" / "validation", split="validation")
    assert tcli.main(["bfs_chains", "--configs-dir", CONFIGS, f"gflownet.g_agent_dir={root / 'art' / 'g_agent'}",
                      f"eval.artifacts_dir={root / 'art'}", "eval.splits=[validation]",
                      f"paths.log_dir={root / 'logs'}"]) == 0
    return root


@pytest.fixture
def offline_tiktoken(monkeypatch):
    monkeypatch.setitem(sys.modules, "tiktoken", _fake_tiktoken("offline", []))
    tprompting.token_encoding.cache_clear()
    yield
    tprompting.token_encoding.cache_clear()


MODES = {
    "oracle": ["experiment=reasoner_oracle"],
    "mock_triplets": ["reasoner=mock", f"reasoner.mock_response='{MOCK}'", "reasoner.window_k=[1,5,25]"],
    "mock_paths": ["experiment=reasoner_bfs_paths", "reasoner=mock", f"reasoner.mock_response='{MOCK}'",
                   "reasoner.prompt_source=paths", "reasoner.chains_artifact=eval_bfs", "reasoner.path_limit=3"],
}


def _run(pkg_cli, store, tmp_path, name, overrides):
    art = tmp_path / name / "art"
    extra = []
    if "reasoner.prompt_source=paths" in overrides:
        extra.append(f"reasoner.chains_dir={store / 'art' / 'eval_bfs'}")
    rc = pkg_cli.main(["reasoner", "--configs-dir", CONFIGS, f"gflownet.g_agent_dir={store / 'art' / 'g_agent'}",
                       f"eval.artifacts_dir={art}", "eval.splits=[validation]", f"paths.log_dir={tmp_path / name}",
                       "extras.print_config=false", *overrides, *extra])
    assert rc == 0
    (metrics,) = sorted((tmp_path / name).glob("**/runs/*/metrics.json"))
    preds = art / "reasoner" / "validation.jsonl"
    return json.loads(metrics.read_text()), (preds.read_bytes() if preds.exists() else None), art


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reasoner_clis_match_jax(store, tmp_path, offline_tiktoken, mode):
    jm, jpreds, _ = _run(jcli, store, tmp_path, "jax", MODES[mode])
    tm, tpreds, tart = _run(tcli, store, tmp_path, "port", MODES[mode])
    assert tm == jm and tm
    assert tpreds == jpreds
    if mode == "oracle":
        assert "validation/answer_hit@10" in tm and tpreds is None
    else:
        assert tpreds and tm["validation/results/total"] == len(tpreds.splitlines())
        metrics_file = tart / "reasoner" / "validation.jsonl.metrics.json"
        assert json.loads(metrics_file.read_text()) == {k.split("/", 1)[1]: v for k, v in tm.items()}
    if mode == "mock_paths":
        assert tm["validation/results/hit"] > 0 and "Paths:" in json.loads(tpreds.splitlines()[0])["prompt"]


class _Stub(BaseHTTPRequestHandler):
    failures_left = 0
    seen: list = []

    def do_POST(self):  # noqa: N802 (http.server API)
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).seen.append((self.path, body))
        if type(self).failures_left > 0:
            type(self).failures_left -= 1
            self.send_response(500, "boom")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(json.dumps({"message": {"role": "assistant", "content": MOCK}}).encode())

    def log_message(self, *a):
        pass


def test_port_reasoner_over_http(store, tmp_path, offline_tiktoken, monkeypatch):
    monkeypatch.setattr("evi_rag_tpu_torch.eval.llm_client.time.sleep", lambda s: None)
    _Stub.failures_left, _Stub.seen = 1, []
    srv = HTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        m, preds, _ = _run(tcli, store, tmp_path, "http", [
            "reasoner=ollama", f"reasoner.ollama_base_url=http://127.0.0.1:{srv.server_address[1]}",
            "reasoner.ollama_timeout=10", "reasoner.window_k=[2]", "reasoner.max_tokens=64"])
    finally:
        srv.shutdown()
        t.join(timeout=5)
        srv.server_close()
    assert len(_Stub.seen) == 4 + 1  # 4 samples x 1 window, plus the retried 500
    path, body = _Stub.seen[-1]
    assert path == "/api/chat" and body["model"] == "llama3.1" and body["stream"] is False
    assert body["options"]["num_predict"] == 64 and "Triplets:" in body["messages"][-1]["content"]
    assert m["validation/results/total"] == 4 and json.loads(preds.splitlines()[0])["prediction"] == MOCK
