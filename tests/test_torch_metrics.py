"""The port's ``stats()`` surface and its Prometheus text against the JAX
package's (CPU), the engine half of
``tests/test_observability.py::TestPrometheusExposition`` and of
``tests/test_kv_offload.py::TestOffloadObservability`` (their HTTP half
waits for the serving shell, ROADMAP.md queue A, item 9b):

- ``stats()``'s key set, compared recursively, is the JAX engine's on
  three configurations (slots; paged with the KV tier; speculating),
  but for the port's two speculation reservoirs;
- ``serving/metrics.py``'s exposition is lifted: its counter set is
  JAX's, and one hand-built snapshot renders to JAX's text byte for
  byte;
- ``prometheus_text({"models": {"lm": stats()}})`` passes
  ``tests/_obs_util.py``'s parity walker on the three configurations,
  and its (family, type) set is the JAX engine's on the same traffic,
  but for the two reservoirs' families."""
import jax
import numpy as np
import pytest

from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu.serving import metrics as jmetrics
from deeplearning4j_tpu.zoo.transformer_lm import CausalTransformerLM as JaxLM
from deeplearning4j_tpu_torch.serving import (GenerationEngine,
                                              GenerationMetrics,
                                              prometheus_text)
from deeplearning4j_tpu_torch.serving import metrics as tmetrics
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

from _obs_util import assert_exposition_parity, parse_prometheus

VOCAB = 64
CFG = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2,
           max_seq_len=32)
BASE = dict(num_slots=2, max_queue=16, min_prompt_bucket=4)
CONFIGS = {
    "slots": dict(BASE),
    "paged_offload": dict(BASE, cache="paged", block_size=8,
                          prefill_chunk_tokens=8, num_blocks=9,
                          offload_host_bytes=1 << 20),
    "speculating": dict(BASE, speculation_k=2),
}
#: the port's own stats() keys: the draft call's and the verify span's
#: latency reservoirs
PORT_ONLY = {"spec_draft_ms", "spec_verify_ms"}
LAB = '{model="lm"}'


def _prompt(i):
    return [(3 * i + j) % (VOCAB - 8) + 1 for j in range(12)]


def _traffic(eng, cfg):
    """One request at a time (so the occupancy histogram is the same on
    both engines); two-turn sessions on the KV tier's pool of ~2, so
    sessions demote and restore."""
    if "offload_host_bytes" in cfg:
        outs = [eng.generate(_prompt(i), max_tokens=4, session_id=f"s{i}",
                             timeout_ms=120_000)["tokens"] for i in range(4)]
        for i in range(4):
            eng.generate(_prompt(i) + outs[i] + [7, 11], max_tokens=3,
                         session_id=f"s{i}", timeout_ms=120_000)
    else:
        for i in range(3):
            eng.generate(_prompt(i), max_tokens=6, seed=i,
                         timeout_ms=120_000)


@pytest.fixture(scope="module")
def lms():
    jlm = JaxLM(**CFG, seed=0, implementation="plain").init()
    lm = CausalTransformerLM(**CFG, seed=0, device="cpu").load_params(
        jax.tree.map(np.asarray, jlm._params))
    return jlm, lm


@pytest.fixture(scope="module")
def snapshots(lms):
    """Each configuration's ``stats()`` on the JAX engine and the port's
    after the same traffic (the speculating engines draft with a
    same-weights copy of the target)."""
    jlm, lm = lms
    out = {}
    for name, cfg in CONFIGS.items():
        snaps = []
        for cls, model in ((JaxEngine, jlm), (GenerationEngine, lm)):
            kw = dict(cfg)
            if "speculation_k" in kw:
                kw["draft_model"] = (
                    JaxLM(**CFG, seed=0, implementation="plain").init()
                    if cls is JaxEngine else
                    CausalTransformerLM(**CFG, seed=0, device="cpu")
                    .load_params(jax.tree.map(np.asarray, jlm._params)))
            eng = cls(model, **kw)
            try:
                _traffic(eng, cfg)
                snaps.append(eng.stats())
            finally:
                eng.stop()
        out[name] = tuple(snaps)
    return out


def _keys(obj, path=()):
    """Every key path of a snapshot; a histogram (int-keyed dict) is one
    leaf, whatever buckets the traffic filled."""
    if not isinstance(obj, dict) or (
            obj and all(isinstance(k, int) for k in obj)):
        return {path}
    out = {path}
    for k, v in obj.items():
        out |= _keys(v, path + (k,))
    return out


def _families(stats):
    _, types = parse_prometheus(prometheus_text({"models": {"lm": stats}}))
    return set(types.items())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stats_key_set_is_jax_engine_keys(snapshots, config):
    jsnap, tsnap = snapshots[config]
    jkeys, tkeys = _keys(jsnap), _keys(tsnap)
    assert jkeys - tkeys == set(), "keys the port lacks"
    extra = {p for p in tkeys - jkeys if p[0] not in PORT_ONLY}
    assert extra == set(), "keys only the port has"
    assert tsnap["client_errors"] == 0
    assert jsnap["cache_backend"] == tsnap["cache_backend"]
    if config == "paged_offload":
        assert tsnap["paged"]["offload"]["restores"] > 0
    if config == "speculating":
        assert tsnap["spec"]["verify_batches"] > 0


def test_client_errors_counter_and_snapshot_key():
    m = GenerationMetrics()
    assert m.snapshot()["client_errors"] == 0
    m.inc("client_errors", 3)
    assert m.snapshot()["client_errors"] == 3
    assert list(m.snapshot()).index("client_errors") == \
        list(jmetrics.GenerationMetrics().snapshot()).index("client_errors")


def test_prom_counters_are_jax_counters():
    assert tmetrics._PROM_COUNTERS == jmetrics._PROM_COUNTERS
    assert tmetrics._RESERVOIR_KEYS == jmetrics._RESERVOIR_KEYS


def _hand_snapshot():
    """Every shape the walker handles: nested dicts, counters by leaf
    name, gauges, a bool, a reservoir, an int-keyed histogram, a list,
    strings (skipped), a label value that needs escaping, a leading
    digit and a non-identifier character in a key."""
    res = {"count": 3, "mean": 1.5, "p50": 1.25, "p90": 2.0, "p99": 2.5,
           "max": 2.75}
    model = {"requests": 7, "responses": 6, "client_errors": 1,
             "tokens_per_sec": 12.5, "enabled": True,
             "faults": {"retries": 2, "recoveries": 0},
             "ttft_ms": res, "occupancy_hist": {1: 4, 2: 9},
             "warmed_buckets": [8, 16], "kv_dtype": "int8",
             "paged": {"offload": {"restores": 3, "host_bytes": 1024}},
             "2nd-level": {"x.y": 0.1}}
    return {"summary": {"models": 1, "uptime_s": 9.0},
            "models": {"lm": model, 'odd"name\\': {"requests": 1}},
            "profiler": {"serving.predict": {"count": 2, "mean_ms": 0.5}}}


@pytest.mark.parametrize("which", ["models", "fleet", "generic"])
def test_prometheus_text_is_jax_text(which):
    snap = _hand_snapshot()
    if which == "fleet":
        snap = {"fleet": {"requests": 4, "hedges": 1,
                          "replicas": [{"id": "r0", "in_flight": 2},
                                       {"id": "r1", "in_flight": 0}]}}
    elif which == "generic":
        snap = snap["models"]["lm"]
    text = prometheus_text(snap)
    assert text == jmetrics.prometheus_text(snap)
    assert text.count("# TYPE") >= 3


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_exposition_parity(snapshots, config):
    """The generic walker of ``tests/_obs_util.py`` finds every numeric
    leaf of the port's ``stats()`` in its text with the documented name,
    type and value; every family has one ``# TYPE``."""
    tsnap = snapshots[config][1]
    stats = {"models": {"lm": tsnap}}
    text = prometheus_text(stats)
    samples, types = parse_prometheus(text)
    assert assert_exposition_parity(stats, samples, types) > 50
    type_lines = [ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE")]
    assert len(type_lines) == len(set(type_lines))
    assert samples[("dl4j_model_tokens_generated_total", LAB)] == \
        tsnap["tokens_generated"]
    assert samples[("dl4j_model_client_errors_total", LAB)] == 0
    if config == "paged_offload":
        stem = "dl4j_model_paged_offload_"
        assert samples[(f"{stem}restores_total", LAB)] == \
            tsnap["paged"]["offload"]["restores"]
        assert types[f"{stem}restore_ms"] == "summary"
    if config == "speculating":
        assert samples[("dl4j_model_spec_verify_batches_total", LAB)] == \
            tsnap["spec"]["verify_batches"]
        assert types["dl4j_model_spec_accept_rate"] == "gauge"


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_families_are_jax_engine_families(snapshots, config):
    jsnap, tsnap = snapshots[config]
    port_only = {(f"dl4j_model_{r}{sfx}", t) for r in PORT_ONLY
                 for sfx, t in (("", "summary"), ("_count", "summary"),
                                ("_mean", "gauge"), ("_max", "gauge"))}
    tfam, jfam = _families(tsnap), _families(jsnap)
    assert port_only <= tfam
    assert tfam - port_only == jfam
