"""Every traffic mix kept under mixes/, those of no cell yet included:
each distinct instance, sent on the CPU at a tiny scale through a
CoordinatorServer by the port's client as a stream sends it, equals the
plain reference, and the float64 control does not."""

import glob
import importlib
import json
import os

import pytest

from portbench import compare, data, traffic
from portbench.reference.common import Ctx

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(HERE, "mixes", "*.json")))


def _load(path):
    with open(path) as f:
        return json.load(f)


CONFIGS = {c["generator"]: c for c in map(_load, glob.glob(os.path.join(HERE, "configs", "*.json")))}
TINY = {"tpch": 0.01, "tpcds": 0.1}


@pytest.mark.parametrize("mix_name", MIXES)
def test_mix_instances_match_the_reference(mix_name):
    from portbench.sut import Sut
    from trino_tpu_torch.client import Client

    mix = traffic.load_mix(mix_name)
    family = mix["family"]
    tables = data.generate(CONFIGS[family]["generator"], TINY[family], 31, "cpu")
    sut = Sut(tables, CONFIGS[family]["session"], "cpu")
    exact, low = Ctx(tables, "cpu"), Ctx(tables, "cpu", "float64")
    control_off = 0
    client = Client(sut.start_server())
    try:
        for inst in traffic.distinct(traffic.streams(mix, 31)):
            ref = importlib.import_module(f"portbench.reference.{family}.{inst.query}")
            want = ref.run(exact, inst.param_dict)
            # as the streams' process hands the rows on: through JSON
            got = json.loads(json.dumps(client.execute(inst.sql).rows))
            assert compare.mismatched_cells(got, want) == 0, inst.id
            ctl = ref.run(low, inst.param_dict)
            n = ctl.total if ctl.limit is None else min(ctl.limit, ctl.total)
            control_off += compare.mismatched_cells(ctl.rows[:n], want)
    finally:
        sut.stop_server()
    assert control_off > 0
