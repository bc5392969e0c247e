"""A failing-device rig shared by the port's serving tests, for the JAX
engine and the port's alike: which decode, prefill and prefill-chunk
device calls raise (as a kernel or launch error would), and a gate that
holds a scheduler at its next iteration so requests submitted meanwhile
are admitted together, in order."""
import threading
import time

from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu_torch.zoo.transformer_lm import CausalTransformerLM

MESSAGES = {"decode": "decode_attention: CUDA error 700 at launch",
            "prefill": "flash_attention: CUDA error 700 at launch",
            "chunk": "prefill chunk: CUDA error 700 at launch"}


class Rig:
    """``arm(decode=..., prefill=..., chunk=...)``: each kind of device
    call raises ``RuntimeError(MESSAGES[kind])`` always (``"always"``)
    or at the given 1-based calls of that kind counted from ``arm``;
    ``decode_sleep_s`` slows every decode call."""

    def __init__(self):
        self.fail = {}
        self.calls = dict.fromkeys(MESSAGES, 0)
        self.decode_sleep_s = 0.0

    def arm(self, **fail):
        self.fail = fail
        self.calls = dict.fromkeys(MESSAGES, 0)

    def check(self, kind):
        self.calls[kind] += 1
        if kind == "decode":
            time.sleep(self.decode_sleep_s)
        f = self.fail.get(kind)
        if f == "always" or (f and self.calls[kind] in f):
            raise RuntimeError(MESSAGES[kind])

    def wrap(self, kind, exe):
        def call(*args, **kw):
            self.check(kind)
            return exe(*args, **kw)
        return call


class RigLM(CausalTransformerLM):
    """The port's model whose device calls consult ``self.rig``."""

    rig = None

    def forward_decode(self, *args, **kw):
        self.rig.check("decode")
        return super().forward_decode(*args, **kw)

    def forward_decode_paged(self, *args, **kw):
        self.rig.check("decode")
        return super().forward_decode_paged(*args, **kw)

    def forward_prefill(self, *args, **kw):
        self.rig.check("prefill")
        return super().forward_prefill(*args, **kw)

    def forward_prefill_chunk(self, *args, **kw):
        self.rig.check("chunk")
        return super().forward_prefill_chunk(*args, **kw)


def jax_engine(jlm, rig, **kw):
    """The JAX engine whose decode, prefill and chunk executables
    consult ``rig`` before each call."""

    class _RigEngine(JaxEngine):
        def _get_decode_exe(self):
            return rig.wrap("decode", super()._get_decode_exe())

        def _get_prefill_exe(self, bucket):
            return rig.wrap("prefill", super()._get_prefill_exe(bucket))

        def _get_chunk_exe(self, chunk_bucket, tbl_bucket):
            return rig.wrap("chunk", super()._get_chunk_exe(chunk_bucket,
                                                            tbl_bucket))

    return _RigEngine(jlm, **kw)


class Gate:
    """Injector stand-in that holds the scheduler at its ``latency``
    seam until opened."""

    def __init__(self):
        self.held = threading.Event()
        self.open = threading.Event()

    def fire(self, seam, worker=None):
        if seam == "latency" and not self.open.is_set():
            self.held.set()
            self.open.wait(30.0)
        return False


def gated_streams(eng, reqs):
    """Stream ``reqs`` (keyword dicts) submitted in order while the
    scheduler is held, so one iteration admits them in that order.
    Returns each request's outcome: its tokens, or (tokens streamed,
    error class name, message) when it failed."""
    gate = Gate()
    eng.set_fault_injector(gate)
    try:
        assert gate.held.wait(10.0)
        streams = [eng.stream(timeout_ms=120_000, **r) for r in reqs]
    finally:
        gate.open.set()
    out = []
    for s in streams:
        toks = []
        try:
            for chunk in s:
                if "token" in chunk:
                    toks.append(chunk["token"])
            out.append(toks)
        except Exception as e:  # noqa: BLE001 — the outcome under test
            out.append((toks, type(e).__name__, str(e)))
    eng.set_fault_injector(None)
    return out
