"""The skew-aware join plane of trino_tpu_torch (device="cpu") against
trino_tpu: tests/test_skew_join.py's 13 cases on the port's names
(tests/test_torch_adaptive.adaptive_names; the mesh runners get 8 CPU
shards).

- The heavy-hitter classifier, the salted repartition on the mesh plane
  (the adaptive controller's skew annotation turns it on), the MXU
  join-project route and the spill-mode re-plan run as written. The
  salted page-plane oracle comes from a port runner with mesh_execution
  off. The chunk-count rung the corpus marks slow stays out of tier 1,
  as in the reference.
- The warm salted repeat reads jax's compile counter: a port-side copy
  reads the port's, `programs_built`.
- A salted run against the same run with salting off: the hot key's
  build rows sit on every shard, and the rows are equal.
"""

import inspect

import pytest

import tests.test_skew_join as skew_corpus
from tests.test_torch_adaptive import clean_tiers, corpus_params, adaptive_names  # noqa: F401
from tests.test_torch_compile import isolated_registries  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu_torch.runtime.metrics import METRICS


@pytest.fixture(scope="module")
def salt_oracle():
    """The page plane's answer, on the port."""
    mp = pytest.MonkeyPatch()
    adaptive_names(mp, skew_corpus)
    try:
        return skew_corpus._mk_mesh(mesh_execution=False).execute(skew_corpus.SALT_SQL).rows
    finally:
        mp.undo()


COPIES = {"test_salted_warm_repeat_zero_relowerings": "test_salted_warm_repeat_builds_nothing"}
SKEW = [n for _, n in _cases(skew_corpus) if n not in COPIES]


@pytest.mark.parametrize("name,kwargs", corpus_params(skew_corpus, SKEW))
def test_skew_join_corpus(name, kwargs, salt_oracle, monkeypatch):
    adaptive_names(monkeypatch, skew_corpus)
    fn = getattr(skew_corpus, name)
    args = {"salt_oracle": salt_oracle, "monkeypatch": monkeypatch, **kwargs}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def test_the_corpus_is_whole():
    assert len(_cases(skew_corpus)) == 13
    assert set(SKEW) | set(COPIES) == {n for _, n in _cases(skew_corpus)}


def test_salted_warm_repeat_builds_nothing(salt_oracle, monkeypatch):
    """tests/test_skew_join.py's warm-repeat gate on the port's counter:
    the second salted run builds no program and stays on the mesh."""
    adaptive_names(monkeypatch, skew_corpus)
    r = skew_corpus._mk_salted(mesh_chunk_rows=256)
    assert r.execute(skew_corpus.SALT_SQL).rows == salt_oracle
    before = METRICS.counter("programs_built")
    assert r.execute(skew_corpus.SALT_SQL).rows == salt_oracle
    assert METRICS.counter("programs_built") - before == 0
    assert r._last_data_plane == "mesh", r.last_mesh_fallback


def test_the_hot_keys_build_rows_sit_on_every_shard(salt_oracle, monkeypatch):
    """The salted exchange leaves the hot key's build rows on every
    shard and each cold key's on exactly one, and the rows equal the
    page plane's."""
    from trino_tpu_torch.parallel import mesh_chunk

    adaptive_names(monkeypatch, skew_corpus)
    seen = []
    orig = mesh_chunk.ChunkedMeshRunner._emit_exchange

    def spy(self, frag, batches, ctx):
        orig(self, frag, batches, ctx)
        sk = self.skew_map.get(frag.id)
        if sk is not None and sk[0] == "build":
            ch = frag.output_channels[0]
            seen.append((sk[1], [b.columns[ch].data[b.live_mask()].tolist()
                                 for b in ctx[frag.id]]))

    monkeypatch.setattr(mesh_chunk.ChunkedMeshRunner, "_emit_exchange", spy)
    r = skew_corpus._mk_salted(mesh_chunk_rows=0)
    assert r.execute(skew_corpus.SALT_SQL).rows == salt_oracle
    assert r._last_adaptive_report.salted_joins == 1
    assert seen  # once a run attempt (an overflow restart runs it again)
    hot, per_shard = seen[-1]
    assert hot and len(per_shard) == 8
    for key in hot:
        counts = [keys.count(key) for keys in per_shard]
        assert min(counts) > 0 and len(set(counts)) == 1, counts
    cold = {k for keys in per_shard for k in keys if k not in hot}
    assert cold and all(sum(k in keys for keys in per_shard) == 1 for k in cold)
