"""Reference corpora over code the port has had since its first slices:
tests/test_parser.py, test_optimizer.py, test_block.py and
test_floatbits.py run as written with their names bound to the port's
(tests/test_torch_distributed.portify; runners on the CPU), and
explain_corpus/01_transitive_predicate.txt and 02_scan_pushdown.txt are
regenerated through the port and equal the committed text.

Where a corpus builds its inputs with jax.numpy (test_block.py's mask
and gather, test_floatbits.py's keys), a stand-in gives it torch tensors
of the same values; test_floatbits.py's keys are also held equal to the
reference's.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import tests.test_block as block_corpus
import tests.test_floatbits as floatbits_corpus
import tests.test_optimizer as optimizer_corpus
import tests.test_parser as parser_corpus
from tests.test_torch_distributed import call_case, portify
from tests.test_torch_statements import _cases, _ids
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from tests.tpch_queries import QUERIES
from trino_tpu.ops.floatbits import f64_lanes as jf64_lanes
from trino_tpu_torch.ops.floatbits import f64_lanes

CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                          "explain_corpus")

# jax.numpy's two calls the corpora make, answering torch tensors
TORCH_NP = types.SimpleNamespace(
    asarray=lambda v, dtype=None: torch.as_tensor(np.asarray(v), dtype=dtype),
    float64=torch.float64,
)


# ---- tests/test_parser.py ---------------------------------------------------------

_PARSER = _cases(parser_corpus, skip={"test_tpch_queries_parse"})


@pytest.mark.parametrize("case", _PARSER, ids=_ids(_PARSER))
def test_parser_corpus(case, monkeypatch):
    portify(monkeypatch, parser_corpus)
    call_case(parser_corpus, case, {})


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_parser_corpus_tpch(qid, monkeypatch):
    portify(monkeypatch, parser_corpus)
    parser_corpus.test_tpch_queries_parse(qid)


# ---- tests/test_optimizer.py ------------------------------------------------------

_OPTIMIZER = _cases(optimizer_corpus)


@pytest.fixture(scope="module")
def optimizer_runner():
    mp = pytest.MonkeyPatch()
    portify(mp, optimizer_corpus)
    try:
        return optimizer_corpus.runner.__wrapped__()
    finally:
        mp.undo()


@pytest.mark.parametrize("case", _OPTIMIZER, ids=_ids(_OPTIMIZER))
def test_optimizer_corpus(case, monkeypatch, optimizer_runner):
    portify(monkeypatch, optimizer_corpus)
    call_case(optimizer_corpus, case, {"runner": lambda: optimizer_runner})


# ---- tests/test_block.py, test_floatbits.py -------------------------------------------

_BLOCK = _cases(block_corpus)
_FLOATBITS = _cases(floatbits_corpus)


@pytest.mark.parametrize("case", _BLOCK, ids=_ids(_BLOCK))
def test_block_corpus(case, monkeypatch):
    import jax

    portify(monkeypatch, block_corpus)
    # the mask and gather cases import jax.numpy in their bodies
    monkeypatch.setattr(jax, "numpy", TORCH_NP)
    call_case(block_corpus, case, {})


@pytest.mark.parametrize("case", _FLOATBITS, ids=_ids(_FLOATBITS))
def test_floatbits_corpus(case, monkeypatch):
    monkeypatch.setattr(floatbits_corpus, "jnp", TORCH_NP)
    monkeypatch.setattr(floatbits_corpus, "f64_lanes", f64_lanes)
    call_case(floatbits_corpus, case, {})


def test_floatbits_keys_equal_the_reference():
    import jax.numpy as jnp

    vals = floatbits_corpus._interesting_values() + [float("inf"), float("-inf"),
                                                     float("nan")]
    want = [np.asarray(lane, dtype=np.uint64) for lane in jf64_lanes(jnp.asarray(vals))]
    got = [np.asarray(lane, dtype=np.uint64)
           for lane in f64_lanes(torch.tensor(vals, dtype=torch.float64))]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


# ---- explain_corpus/01 and 02 ------------------------------------------------------------

_EXPLAIN = {"01_transitive_predicate.txt": "corpus_01_transitive",
            "02_scan_pushdown.txt": "corpus_02_scan_pushdown"}


@pytest.fixture(scope="module")
def generate():
    spec = importlib.util.spec_from_file_location(
        "explain_corpus_generate", os.path.join(CORPUS_DIR, "generate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(_EXPLAIN))
def test_explain_corpus(name, generate, monkeypatch, tmp_path):
    portify(monkeypatch, generate)
    monkeypatch.setattr(generate, "_OUT_DIR", [str(tmp_path)])
    getattr(generate, _EXPLAIN[name])()
    with open(os.path.join(CORPUS_DIR, name)) as fh:
        committed = fh.read()
    assert (tmp_path / name).read_text() == committed


def test_the_corpora_are_covered():
    """Every case of the four corpora runs above; of explain_corpus/, 01
    and 02 (the other files hold the census, compile, distributed, mesh,
    resident and adaptive tiers' lines)."""
    assert (len(_PARSER) + 1, len(_OPTIMIZER), len(_BLOCK), len(_FLOATBITS)) == (20, 18, 7, 3)
    assert {n for n in os.listdir(CORPUS_DIR) if n.endswith(".txt")} >= set(_EXPLAIN)
