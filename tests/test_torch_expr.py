"""tests/test_expr.py's 42 expression-binder cases on trino_tpu_torch's
ExprBinder (device="cpu" batches).

The corpus runs as written with its names bound to the port's: types,
block (RelBatch, Column, Dictionary), the IR and a `bind_expr` whose
Bound evaluates a batch as the reference's does. test_bound_under_jit
checks that the bound closure traces under jax.jit; the port's closure
is an eager torch function, so there `jax.jit` is the identity and the
case checks the closure's answer on the batch's tensors.
"""

import inspect
import types

import pytest

import tests.test_expr as expr_corpus
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch import types as T
from trino_tpu_torch.block import Column, Dictionary, RelBatch
from trino_tpu_torch.expr import ir
from trino_tpu_torch.expr.compile import ExprBinder

CASES = sorted(n for n, f in vars(expr_corpus).items()
               if n.startswith("test_") and inspect.isfunction(f))


class _Bound:
    """The reference's Bound surface over a port Bound: `fn` and
    `eval_batch`."""

    def __init__(self, bound):
        self.bound = bound
        self.fn = bound.fn

    def eval_batch(self, batch: RelBatch) -> Column:
        data, valid = self.fn([c.data for c in batch.columns],
                              [c.valid for c in batch.columns])
        return Column(self.bound.type, data, valid, self.bound.dictionary)


def _bind_expr(expr, batch):
    return _Bound(ExprBinder([c.type for c in batch.columns],
                             [c.dictionary for c in batch.columns]).bind(expr))


@pytest.fixture()
def port_names(monkeypatch):
    for name, value in (("T", T), ("ir", ir), ("Column", Column), ("Dictionary", Dictionary),
                        ("RelBatch", RelBatch), ("ExprBinder", ExprBinder),
                        ("bind_expr", _bind_expr),
                        ("jax", types.SimpleNamespace(jit=lambda f: f))):
        monkeypatch.setattr(expr_corpus, name, value)
    # the corpus's module-level schema was built from the reference's types
    monkeypatch.setattr(expr_corpus, "SCHEMA", [
        (n, T.decimal(t.precision, t.scale) if t.kind.name == "DECIMAL"
         else getattr(T, t.kind.name)) for n, t in expr_corpus.SCHEMA])


@pytest.mark.parametrize("name", CASES)
def test_expr_corpus_on_the_port(name, port_names):
    fn = getattr(expr_corpus, name)
    if "batch" in inspect.signature(fn).parameters:
        fn(expr_corpus.batch_of(expr_corpus.SCHEMA, expr_corpus.DATA))
    else:
        fn()


def test_the_corpus_is_covered():
    assert len(CASES) == 42
