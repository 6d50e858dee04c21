"""The engine's decode step as ``serve/artifacts.decode_artifacts`` builds it,
against the JAX engine, on the CPU.

On the card the decode step is a CUDA graph over the parameters, every cache
leaf and the token buffer, so the engine must hand the step the same
storages at every call.  Here, for the three families at smoke width with
more requests than slots (so slots are refilled between steps): every cache
leaf and the token buffer keep their storage from the first step on; the
greedy tokens equal the JAX engine's; and the trace has one ``compile`` row
for the decode step and one ``dispatch`` row a step, as the JAX engine's.
The replay itself runs only on the card (``test_torch_decode_graph_cuda.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import TraceConfig as JaxTraceConfig
from repro.core import Tracer as JaxTracer
from repro.core.babeltrace import CTFSource as JaxCTFSource
from repro.models import Model as JaxModel
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import TraceConfig, Tracer
from repro_torch.core.babeltrace import CTFSource
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.artifacts import decode_artifacts, storages

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "h2o-danube-1.8b")
PROMPT_LENS = (8, 16, 8, 24, 8)  # five requests over two slots: three refills
SERVE = dict(batch_slots=2, cache_len=32, max_new_tokens=4)


def _step_rows(source_cls, trace_dir) -> dict:
    """Calls of each runtime row whose function is the decode step."""
    out = {"compile": 0, "dispatch": 0}
    for e in source_cls(trace_dir):
        for api in out:
            if e.name.endswith(f":{api}_entry") and e.field("fn").startswith("decode_step["):
                out[api] += 1
    return out


def _decode_calls(source_cls, trace_dir) -> int:
    return sum(e.name == "ust_repro:decode_step_entry" for e in source_cls(trace_dir))


@pytest.fixture(scope="module", params=ARCHS)
def served(request, tmp_path_factory):
    """The same smoke model, weights and prompts through both engines under a
    trace; the port's engine records its storages after every step."""
    arch = request.param
    jm = JaxModel(jax_get_config(arch).smoke())
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(arch).smoke())
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jm.cfg.vocab_size, size=(S,)) for S in PROMPT_LENS]

    jd = str(tmp_path_factory.mktemp("jax"))
    je = JaxServeEngine(jm, jp, JaxServeConfig(**SERVE))
    jreqs = [je.submit(p) for p in prompts]
    with JaxTracer(JaxTraceConfig(out_dir=jd, mode="default")):
        je.run_until_drained()

    td = str(tmp_path_factory.mktemp("torch"))
    te = ServeEngine(tm, tp, ServeConfig(**SERVE))
    treqs = [te.submit(p) for p in prompts]
    seen = []
    with Tracer(TraceConfig(out_dir=td, mode="default")):
        while te.step() or te.queue:
            seen.append(storages((te.cache, te._tok)))
    return dict(
        arch=arch, engine=te, model=tm, seen=seen,
        tokens=([r.out_tokens for r in jreqs], [r.out_tokens for r in treqs]),
        dirs=(jd, td),
    )


def test_cache_leaves_and_token_buffer_keep_their_storage(served):
    seen = served["seen"]
    assert len(seen) > 3 and all(s == seen[0] for s in seen[1:])
    # slots were refilled between steps: the splice wrote into those storages
    names = [e.name for e in CTFSource(served["dirs"][1])]
    first = names.index("ust_repro:decode_step_entry")
    assert names[first:].count("ust_repro:prefill_entry") == len(PROMPT_LENS) - SERVE["batch_slots"]


def test_greedy_tokens_equal_the_jax_engines(served):
    jtoks, ttoks = served["tokens"]
    assert ttoks == jtoks and all(len(t) == SERVE["max_new_tokens"] for t in ttoks)


def test_one_compile_row_and_one_dispatch_row_a_step(served):
    jd, td = served["dirs"]
    steps = _decode_calls(CTFSource, td)
    assert steps == len(served["seen"]) == _decode_calls(JaxCTFSource, jd)
    assert _step_rows(CTFSource, td) == {"compile": 1, "dispatch": steps}
    assert _step_rows(CTFSource, td) == _step_rows(JaxCTFSource, jd)


def test_decode_artifacts_is_the_models_step_on_the_cpu(served):
    model = served["model"]
    assert decode_artifacts(model, "cpu") == model.decode_step
    assert served["engine"].decode_fn == model.decode_step
    with pytest.raises(ValueError, match="no decode step"):
        decode_artifacts(model, "meta")


def test_storages_follow_nested_trees():
    a, b, c = torch.zeros(2), torch.ones(3), torch.zeros(1)
    tree = {"x": a, "g": {"y": [b, (c,)]}, "n": 3}
    assert storages(tree) == (a.data_ptr(), b.data_ptr(), c.data_ptr())
