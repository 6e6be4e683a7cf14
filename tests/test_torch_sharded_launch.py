"""Every family that trains sharded, on the CPU: each family's smoke arch
through the launch backend at mesh (pod=1, data=2, model=2) over four
spawned gloo ranks (`tests/_ranks.py`, one thread each; the group's size
is data x model, so the pods stack on every rank), against `repro.run`
on 4 host devices in a subprocess; qwen1.5-110b's Megatron FFN
(`mlp_tp`) at (1, 1, 2) over two ranks against the reference's
`train_consensus_lm` on 2; and the families not ported yet refused by
name on such a mesh.

Standards (observed values in ROADMAP queue 3): `assert_results_match`
with the losses within the dense family's rtol 5e-4, T = 6, h = 2, B = 2,
S = 32 (observed: musicgen-medium 1.6e-4, falcon-mamba-7b 1.2e-4,
zamba2-2.7b 3.6e-4, qwen1.5-110b with mlp_tp 2.9e-4). The sharded sums
(the output projections' partial sums over 'model', the Megatron FFN's
down projection, the SSM's channel-sharded projections) round otherwise
than XLA's, and the bf16 trace carries the difference on.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.convert import assert_results_match
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import (SHARDED_FAMILIES, check_sharded_family,
                                     train_consensus_lm)
from repro_torch.models import registry

import _ranks
from test_torch_distributed import SPEC, _reference, _result

TRACE_RTOL = 5e-4
#: a smoke arch of every family kept: audio, state-space, hybrid
FAMILIES = ("musicgen-medium", "falcon-mamba-7b", "zamba2-2.7b")

_MLP_TP_SCRIPT = """
import dataclasses, json
from repro.core.schedules import Periodic
from repro.launch.mesh import make_mesh
from repro.launch.train import train_consensus_lm
from repro.models import registry
from repro.optim import adamw, cosine_lr

cfg = dataclasses.replace(registry.get_config("qwen1.5-110b", "smoke"),
                          mlp_tp=True)
rep = train_consensus_lm(cfg, adamw(cosine_lr(3e-4, 6)),
                         make_mesh((1, 1, 2), ("pod", "data", "model")),
                         steps=6, schedule=Periodic(h=2), batch_per_node=2,
                         seq_len=32, seed=0, log_every=0)
print("RESULT " + json.dumps(rep.losses))
"""


def _spec(arch: str) -> dict:
    return dict(SPEC, name=f"sharded_{arch}",
                problem={"kind": "lm", "params": {
                    "arch": arch, "variant": "smoke", "batch_per_node": 2,
                    "seq_len": 32}},
                backends=[{"kind": "launch", "params": {"mesh": [1, 2, 2]}}])


_REF_SCRIPT = """
import json, sys
import repro
out = {name: repro.run(repro.ExperimentSpec.from_dict(spec)).to_dict()
       for name, spec in json.loads(sys.argv[1]).items()}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def family_runs():
    """The reference's runs (4 host devices, and 2 for mlp_tp) and the
    port's on four ranks and two."""
    specs = {arch: _spec(arch) for arch in FAMILIES}
    ref = _reference(_REF_SCRIPT, 4, json.dumps(specs))
    ref_tp = _reference(_MLP_TP_SCRIPT, 2, "")
    four = _ranks.spawn(_ranks.sharded, 4, {"specs": specs}, timeout=600)
    two = _ranks.spawn(_ranks.sharded, 2, {"mlp_tp": [1, 1, 2]})
    return {"reference": _result(ref), "reference_mlp_tp": _result(ref_tp),
            "four": four, "two": two}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trains_sharded_as_the_reference(family_runs, arch):
    ours = family_runs["four"][0][arch]
    ref = family_runs["reference"][arch]
    np.testing.assert_allclose(ours["trace"]["fvals"], ref["trace"]["fvals"],
                               rtol=TRACE_RTOL)
    ours = json.loads(json.dumps(ours))
    ours["trace"]["fvals"] = ref["trace"]["fvals"]
    ours["trace"]["fvals_consensus"] = ref["trace"]["fvals_consensus"]
    assert_results_match(ours, ref)
    for rank in family_runs["four"][1:]:
        assert rank[arch]["trace"] == family_runs["four"][0][arch]["trace"]


def test_megatron_ffn_trains_sharded_as_the_reference(family_runs):
    ref = family_runs["reference_mlp_tp"]
    for rank in family_runs["two"]:
        np.testing.assert_allclose(rank["mlp_tp"], ref, rtol=TRACE_RTOL)
    assert family_runs["two"][0]["mlp_tp"] == family_runs["two"][1]["mlp_tp"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-90b"])
def test_unported_family_is_refused_by_name(arch):
    cfg = registry.get_config(arch, "smoke")
    assert cfg.family not in SHARDED_FAMILIES
    mesh = Mesh(("pod", "data", "model"), (1, 2, 2), torch.device("cpu"))
    with pytest.raises(ValueError, match=f"the {cfg.family} family "
                                         f"\\({cfg.name}\\)"):
        train_consensus_lm(cfg, optim.adamw(optim.cosine_lr(3e-4, 6)), mesh,
                           steps=1)
    # a mesh whose pods lie whole takes every family
    check_sharded_family(cfg, dataclasses.replace(mesh, shape=(2, 1, 1)))
