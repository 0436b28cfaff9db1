"""The checkpoint fabric of trino_tpu_torch against trino_tpu.

- tests/test_fabric.py's cases run on the port's names
  (tests/test_torch_adaptive.adaptive_names); its subprocess peer runs
  the port's FabricServer. The warm-join case whose warm-up raises runs
  as a port-side copy: the port keeps that replica out of the pool and
  raises (ROADMAP §3), where the reference joins it anyway.
- For the same key and payload, encode_key and frame_fabric_body give
  the reference's bytes, and a reference FabricClient and the port's
  push to and pull from each other's FabricServer.
- fabric_status() has the reference's keys and attachment fields.
- The typed declines: a push or pull the error tracker gave up on, or
  that the peer answered with an HTTP error, is counted and dropped; any
  other error of the push thread is raised by flush() and stop(), and
  any other error of a pull propagates.
"""

import inspect

import pytest

import tests.test_fabric as fabric_corpus
from tests.test_torch_adaptive import adaptive_names, clean_tiers  # noqa: F401
from tests.test_torch_compile import isolated_registries  # noqa: F401
from tests.test_torch_statements import _cases
from tests.torch_sanitizer import port_concurrency_sanitizer  # noqa: F401
from trino_tpu.runtime import fabric as jfabric
from trino_tpu.runtime import http as jhttp
from trino_tpu.recovery.checkpoint import MeshCheckpointStore as JStore
from trino_tpu_torch.recovery.checkpoint import MeshCheckpoint, MeshCheckpointStore
from trino_tpu_torch.runtime import fabric as tfabric
from trino_tpu_torch.runtime import http as thttp
from trino_tpu_torch.runtime.error_tracker import RetryPolicy
from trino_tpu_torch.runtime.metrics import METRICS
from trino_tpu_torch.runtime.replicas import ReplicaManager

SECRET = fabric_corpus.SECRET
_PORT_CHILD = fabric_corpus._CHILD.replace("from trino_tpu.", "from trino_tpu_torch.")


@pytest.fixture
def child_server(monkeypatch):
    """The corpus's subprocess peer, serving the port's FabricServer."""
    monkeypatch.setattr(fabric_corpus, "_CHILD", _PORT_CHILD)
    yield from fabric_corpus.child_server.__wrapped__()


COPIES = {"test_join_runs_warm_before_pool_entry": "test_a_join_whose_warm_up_raises_stays_out"}
CORPUS = [n for _, n in _cases(fabric_corpus) if n not in COPIES]


@pytest.mark.parametrize("name", CORPUS)
def test_fabric_corpus(name, monkeypatch, request):
    adaptive_names(monkeypatch, fabric_corpus)
    fn = getattr(fabric_corpus, name)
    args = {"child_server": lambda: request.getfixturevalue("child_server"),
            "monkeypatch": lambda: monkeypatch}
    fn(**{p: args[p]() for p in inspect.signature(fn).parameters})


def test_the_corpus_is_whole():
    assert "trino_tpu_torch" in _PORT_CHILD and "from trino_tpu." not in _PORT_CHILD
    assert len(_cases(fabric_corpus)) == 18
    assert set(CORPUS) | set(COPIES) == {n for _, n in _cases(fabric_corpus)}


def test_a_join_whose_warm_up_raises_stays_out():
    """::test_join_runs_warm_before_pool_entry, whose second half the
    port answers otherwise: the warm-up runs before the replica enters
    the pool, and a warm-up that raises leaves it out of the pool with
    the error raised (the reference joins it anyway)."""
    rm = ReplicaManager(2, devices=fabric_corpus.fake_devices(4))
    rm.leave(0)
    order = []
    rm.join(0, warm=lambda: order.append(rm.replicas[0].state))
    assert order == ["left"] and rm.replicas[0].state == "active"
    rm.leave(1)
    epoch = rm.membership_epoch

    def bad_warm():
        raise RuntimeError("warmup exploded")

    with pytest.raises(RuntimeError, match="warmup exploded"):
        rm.join(1, warm=bad_warm)
    assert rm.replicas[1].state == "left" and rm.membership_epoch == epoch


def test_a_failed_warm_up_entry_is_kept_and_the_replica_joins():
    """warm_join_replay keeps a failed entry's error in the entry (as
    the warmup service does) and the replica joins."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.compile.warmup import WarmupEntry
    from trino_tpu_torch.parallel import mesh_chunk

    def boom(_batch):
        raise RuntimeError("kernel build failed")

    entry = WarmupEntry(operator="MeshChunkStep", fn=boom, in_schema=[(T.BIGINT, None)],
                        out_dtypes=("x",), capacities=(16,), device="cpu")
    rm = ReplicaManager(2, devices=fabric_corpus.fake_devices(4))
    rm.leave(0)
    saved = list(mesh_chunk.MESH_WARMUP_ENTRIES)
    mesh_chunk.MESH_WARMUP_ENTRIES[:] = [entry]
    try:
        rm.join(0, warm=lambda: tfabric.warm_join_replay({"classes": [["op", 8, ["int64"]]]}))
    finally:
        mesh_chunk.MESH_WARMUP_ENTRIES[:] = saved
    assert rm.replicas[0].state == "active"
    assert entry.status == "failed" and "kernel build failed" in entry.detail


# ---- bytes on the wire ---------------------------------------------------------


KEYS = [("mesh-ckpt", 4, "fp-0123", (1, 2), ((0, 3),), ((("bigint", None), 1024),), 0, 256, 8),
        ("steal", "mesh-ckpt", 2, frozenset({1, 2})), ("fabric-test", "xproc")]


@pytest.mark.parametrize("key", KEYS)
def test_key_and_frame_bytes_are_the_references(key):
    """The port's encode_key and frame_fabric_body give the reference's
    bytes for the same key and payload (the payload the port's
    export_bytes of a checkpoint)."""
    store = MeshCheckpointStore()
    k, ckpt = fabric_corpus.make_checkpoint("bytes")
    store.put(key, ckpt)
    payload = store.export_bytes(key)
    assert tfabric.encode_key(key) == jfabric.encode_key(key)
    assert tfabric.decode_key(jfabric.encode_key(key)) == key
    ekey = tfabric.encode_key(key)
    assert thttp.frame_fabric_body(ekey, payload) == jhttp.frame_fabric_body(ekey, payload)
    assert thttp.unframe_fabric_body(jhttp.frame_fabric_body(ekey, payload)) == (ekey, payload)
    assert tfabric.checkpoint_digest(payload) == jfabric.checkpoint_digest(payload)


def test_each_package_pushes_to_and_pulls_from_the_other():
    """A reference FabricClient pushes a checkpoint into a port
    FabricServer and pulls it back, and the other way round: the routes,
    the framing and the digest header agree."""
    from trino_tpu.recovery.checkpoint import MeshCheckpoint as JCheckpoint

    key, ckpt = fabric_corpus.make_checkpoint("cross")
    fields = {f: getattr(ckpt, f) for f in ("next_chunk", "n_chunks", "chunk_cap",
                                            "resolved_caps", "carries_host", "tables",
                                            "generations")}
    # the payload is the server package's own checkpoint bytes
    pairs = ((jhttp.FabricClient, thttp.FabricServer, tfabric.HostFabric, MeshCheckpointStore,
              MeshCheckpoint),
             (thttp.FabricClient, jhttp.FabricServer, jfabric.HostFabric, JStore, JCheckpoint))
    for client_cls, server_cls, host_cls, store_cls, ckpt_cls in pairs:
        data = ckpt_cls(**fields).to_bytes()
        store = store_cls()
        srv = server_cls(host_cls(store=store, host_id="x"), internal_secret=SECRET)
        try:
            client = client_cls(srv.uri, internal_secret=SECRET)
            assert client.push_checkpoint(key, data) == {"imported": True}
            pulled, digest = client.pull_checkpoint(key)
            assert pulled is not None and digest == tfabric.checkpoint_digest(pulled)
            assert client.status()["received"] == 1
        finally:
            srv.stop()


def test_fabric_status_has_the_references_fields():
    got, want = tfabric.fabric_status(), jfabric.fabric_status()
    assert set(got) == set(want) and got["attached"] is want["attached"] is False
    tfab = tfabric.Fabric(["http://127.0.0.1:9"], store=MeshCheckpointStore(),
                          internal_secret=SECRET)
    jfab = jfabric.Fabric(["http://127.0.0.1:9"], store=JStore(), internal_secret=SECRET)
    try:
        tfabric.ACTIVE_FABRIC, jfabric.ACTIVE_FABRIC = tfab, jfab
        got, want = tfabric.fabric_status(), jfabric.fabric_status()
        assert set(got) == set(want)
        assert {k: got[k] for k in ("attached", "peers", "queued", "push_failures")} == \
            {k: want[k] for k in ("attached", "peers", "queued", "push_failures")}
    finally:
        tfabric.ACTIVE_FABRIC = jfabric.ACTIVE_FABRIC = None
        tfab.stop()
        jfab.stop()


def test_a_server_without_a_secret_refuses_to_listen(monkeypatch):
    monkeypatch.delenv("TRINO_TPU_INTERNAL_SECRET", raising=False)
    with pytest.raises(RuntimeError, match="internal secret"):
        thttp.FabricServer(tfabric.HostFabric(store=MeshCheckpointStore()))
    srv = thttp.FabricServer(tfabric.HostFabric(store=MeshCheckpointStore()), require_secret=False)
    srv.stop()


# ---- typed declines -------------------------------------------------------------


class _Raising:
    def __init__(self, exc):
        self.exc = exc

    def push_checkpoint(self, key, data, digest=None):
        raise self.exc

    def pull_checkpoint(self, key):
        raise self.exc


def _stored():
    store = MeshCheckpointStore()
    key, ckpt = fabric_corpus.make_checkpoint("declines")
    store.put(key, ckpt)
    return store, key


def test_a_push_that_fails_otherwise_is_raised_by_flush_and_stop():
    store, key = _stored()
    pusher = tfabric.CheckpointPusher(store, [_Raising(KeyError("a bug"))])
    pusher.offer(key)
    with pytest.raises(KeyError, match="a bug"):
        pusher.flush(10.0)
    with pytest.raises(KeyError, match="a bug"):
        pusher.stop()
    assert pusher.push_failures == 0


def test_a_push_the_peer_refuses_with_http_is_counted():
    """The peer answers 500 (its route raised): an HTTP protocol error,
    which the push counts and drops."""
    class _Broken(tfabric.HostFabric):
        def receive_checkpoint(self, ekey, data, digest):
            raise RuntimeError("peer store broken")

    store, key = _stored()
    srv = thttp.FabricServer(_Broken(store=MeshCheckpointStore()), internal_secret=SECRET)
    before = METRICS.counter(tfabric.PUSH_FAILURES)
    try:
        client = thttp.FabricClient(srv.uri, internal_secret=SECRET,
                                    retry_policy=RetryPolicy(max_error_duration_s=0.2))
        pusher = tfabric.CheckpointPusher(store, [client])
        pusher.offer(key)
        assert pusher.flush(10.0)
        pusher.stop()
    finally:
        srv.stop()
    assert (pusher.pushes, pusher.push_failures) == (0, 1)
    assert METRICS.counter(tfabric.PUSH_FAILURES) - before == 1


def test_a_pull_declines_on_a_spent_budget_and_raises_otherwise():
    store = MeshCheckpointStore()
    fab = tfabric.Fabric(["http://127.0.0.1:9"], store=store, internal_secret=SECRET,
                         max_error_duration_s=0.2)
    try:
        before = METRICS.counter(tfabric.PULL_DECLINES)
        assert fab.try_pull(("k",)) is False
        assert fab.pull_declines == 1
        assert METRICS.counter(tfabric.PULL_DECLINES) - before == 1
        fab.clients = [_Raising(KeyError("a bug"))]
        with pytest.raises(KeyError, match="a bug"):
            fab.try_pull(("k",))
    finally:
        fab.stop()


def test_an_undecodable_key_is_a_typed_refusal():
    fab = tfabric.HostFabric(store=MeshCheckpointStore())
    data = MeshCheckpoint(1, 2, 4, {}, (), (), ()).to_bytes()
    out = fab.receive_checkpoint("AAAA", data, tfabric.checkpoint_digest(data))
    assert out == {"imported": False, "reason": "bad_key"} and fab.digest_rejects == 1
    with pytest.raises(tfabric.KeyDecodeError):
        tfabric.decode_key("!!")
