"""The port's lint (``python -m sheeprl_tpu_torch.tools.sheeprl_lint``).

* The repo's lint fixtures for CFG, JRN, TRC, ASY and LCK
  (``tests/test_tools/test_lint.py``), their paths mapped from
  ``sheeprl_tpu/`` to ``sheeprl_tpu_torch/``, give the same rule ids and
  counts through the port's passes as through the JAX package's;
* the port's own INS and JIT cases (the flagship map of the shared loops, a
  host sync planted in a function passed to ``diag.instrument``);
* the entry point on the real tree: clean under its baseline within the 15 s
  budget the JAX lint is held to, non-zero on each planted fixture;
* the baseline round trip, and a one-line why on every shipped entry;
* every config key the JAX package reads has a port reader.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import pytest

from sheeprl_tpu_torch.tools import lint as port_lint
from sheeprl_tpu_torch.tools.lint import (
    Finding,
    apply_baseline,
    asy_pass,
    cfg_pass,
    ins_pass,
    jit_pass,
    jrn_pass,
    lck_pass,
    load_baseline,
    run_passes,
    trc_pass,
    write_baseline,
)
from sheeprl_tpu_torch.tools.lint.loader import RepoIndex
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "sheeprl_tpu_torch" / "tools" / "lint" / "baseline.json"
LINT = [sys.executable, "-m", "sheeprl_tpu_torch.tools.sheeprl_lint"]
FAMILIES = {"INS", "JIT", "CFG", "JRN", "ASY", "TRC", "LCK"}


def _jax_lint():
    """The repo's lint (``tools/lint``) and its test module's fixtures,
    loaded by path: the JAX package's test module puts ``tools/`` on the
    path and imports ``lint`` from there."""
    spec = importlib.util.spec_from_file_location("_jax_lint_fixtures", ROOT / "tests" / "test_tools" / "test_lint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_lint()


# ---------------------------------------------------------------------------
# the JAX lint's fixtures through both packages' passes
# ---------------------------------------------------------------------------

_JRN_EMIT_POSITIVE = """\
class X:
    def go(self):
        self._journal("ok_event")
        self._journal("bad_event")
        self.journal.write("also_bad", step=1)
        gauge = "Telemetry/bogus_gauge"
"""
_JRN_EMIT_NEGATIVE = """\
class X:
    def go(self):
        self._journal("ok_event")
        gauge = "Telemetry/up"
        self._fp.write("not a journal event")
"""
_JRN_EMIT_ATTRIBUTE = """\
class X:
    def go(self):
        self._journal.write("ok_event")
        self._journal.write("mystery_kind")
"""
_JRN_SERVING = """\
class PolicyService:
    def promote(self):
        self._journal.write("ok_event", step=1)
        self._journal.write("ckpt_promote_typo", step=1)
        name = "sheeprl_serve_not_a_registered_metric"
"""
_JRN_EMIT_OK = 'class X:\n    def go(self):\n        self._journal("ok_event")\n'


def _jrn(emitter: str, doc: str = None, path: str = "sheeprl_tpu/diagnostics/emitter.py"):
    return {
        "sheeprl_tpu/diagnostics/schema.py": JAX.JRN_SCHEMA,
        path: emitter,
        "howto/diagnostics.md": JAX.JRN_DOC_OK if doc is None else doc,
    }


def _trc(extra):
    return {"sheeprl_tpu/diagnostics/tracing.py": JAX.TRC_TRACING, **extra}


_ASY_DOUBLE = """\
_CMD_STEP = b"S"

def loop(envs, actions):
    while True:
        envs.step_async(actions)
        envs.step_async(actions)
        obs = envs.step_wait()
"""
_ASY_PRIME_WAIT_TOP = """\
def loop(envs, actions):
    envs.step_async(actions)
    while True:
        obs = envs.step_wait()
        train(obs)
        envs.step_async(actions)
"""
_ASY_PRIME_THEN_LOOP = """\
def loop(envs, a):
    envs.step_async(a)
    for _ in range(3):
        envs.step_async(a)
        obs = envs.step_wait()
"""
_ASY_TWO_RECEIVERS = """\
def loop(player_envs, eval_envs, a):
    while True:
        player_envs.step_async(a)
        eval_envs.step_async(a)
        obs = player_envs.step_wait()
        eobs = eval_envs.step_wait()
"""
_ASY_NESTED_HELPER = """\
def prime(envs, a):
    envs.step_async(a)

def loop(envs, a):
    prime(envs, a)
    while True:
        obs = envs.step_wait()
        envs.step_async(a)
"""
_ASY_LINE_MESSAGES = """\
def loop(envs, a):
    while True:
        envs.step_async(a)
        envs.step_async(a)
        envs.step_wait()
"""

_TRC_UNKNOWN = """\
def dispatch(tracer, group):
    with tracer.span("serve-dipatch"):
        pass
    tracer.emit_complete("serve-scater", 0, 10)
"""
_TRC_CLEAN = """\
import re

def loop(diag, tracer, name):
    with diag.span("rollout"):
        pass
    tracer.emit_complete("serve-dispatch", 0, 10, rows=4)
    with tracer.span(name):          # dynamic name: not checkable
        pass
    tracer.instant("ckpt_promote")   # instants are events, not phases
    re.match("x", "x").span()        # argless .span(): someone else's API
"""
_TRC502_INLINE = """\
class PhaseStats:
    def __init__(self):
        self.buckets_ms = [1, 5, 25, 100]

def build(cfg):
    return PhaseStats2(buckets_ms=(1.0, 10.0, 100.0))
"""
_TRC502_CONFIG = """\
DEFAULT_SLO_BUCKETS_MS = (1.0, 10.0, 100.0)   # ALL-CAPS fallback: allowed

class PhaseStats:
    def __init__(self, buckets_ms=None):
        self.buckets_ms = tuple(float(b) for b in (buckets_ms or DEFAULT_SLO_BUCKETS_MS))

def build(cfg):
    return PhaseStats(buckets_ms=cfg.get("buckets_ms"))
"""

_LCK_MAIN_ONLY = """\
import threading

class Facade:
    def __init__(self):
        self.journal = None
        threading.Thread(target=self._beat, daemon=True).start()

    def open(self, journal):
        self.journal = journal

    def _beat(self):
        if self.journal is not None:
            self.journal.write("beat")
"""
_LCK_EXTRA_LOCK = """\
import threading

class Service:
    def __init__(self):
        self._params_lock = threading.Lock()
        self._compile_lock = threading.Lock()
        self.version = 0
        threading.Thread(target=self._promote_loop, daemon=True).start()

    def _promote_loop(self):
        with self._params_lock:
            self.version += 1

    def compile(self):
        with self._compile_lock:
            with self._params_lock:
                return self.version
"""
_LCK503_BAD = """\
import os
import threading

class RunJournal:
    def __init__(self, fp):
        self._lock = threading.Lock()
        self._fp = fp

    def write(self, kind):
        self._fp.write(kind)

class Telemetry:
    def __init__(self, journal):
        self._journal = journal
        threading.Thread(target=self._beat, daemon=True).start()

    def _beat(self):
        self._journal._fp.write("beat")
"""
_LCK503_GOOD = """\
import os
import threading

class RunJournal:
    def __init__(self, fp):
        self._lock = threading.Lock()
        self._fp = fp

    def write(self, kind):
        with self._lock:
            self._fp.write(kind)
            os.fsync(self._fp.fileno())

class Telemetry:
    def __init__(self, journal):
        self._journal = journal
        threading.Thread(target=self._beat, daemon=True).start()

    def _beat(self):
        self._journal.write("beat")
"""
_LCK504_BAD = """\
import time
import threading

class Monitor:
    def __init__(self):
        self._lock = threading.Lock()
        self._journal_fn = print
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        with self._lock:
            time.sleep(1.0)
            self._journal_fn("heartbeat")
"""
_LCK504_UNCONTENDED = """\
import time
import threading

class Health:
    def __init__(self):
        self._lock = threading.Lock()
        self._journal_fn = print

    def observe(self):
        with self._lock:
            time.sleep(0.01)
            self._journal_fn("fault_injection")
"""
_LCK504_OUTSIDE = """\
import threading

class Monitor:
    def __init__(self):
        self._lock = threading.Lock()
        self._journal_fn = print
        self.beats = 0
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        with self._lock:
            self.beats += 1
        self._journal_fn("heartbeat")
"""
_LCK505_BAD = """\
import threading

class Waiter:
    def __init__(self):
        self._ready = threading.Event()
        self._cv = threading.Condition()

    def block(self):
        self._ready.wait()

    def block_zero(self):
        self._ready.wait(0)

    def cond_no_loop(self):
        with self._cv:
            self._cv.wait(timeout=1.0)
"""
_LCK505_GOOD = """\
import threading

class Waiter:
    def __init__(self):
        self._ready = threading.Event()
        self._cv = threading.Condition()
        self.queue = []

    def poll(self, timeout_s):
        self._ready.wait(0.5)
        self._ready.wait(timeout_s)     # variable timeout: assumed positive

    def cond_loop(self):
        with self._cv:
            while not self.queue:
                self._cv.wait(timeout=1.0)

    def foreign(self, proc, req):
        proc.wait()                     # subprocess.Popen: not an Event
        req.event.wait()                # unknown receiver class: skipped
"""

X = "sheeprl_tpu/algos/x/x.py"
WORKER = "sheeprl_tpu/serving/worker.py"
CFG_ALGO = "sheeprl_tpu/configs/algo/default.yaml"

#: (case id, family, {JAX-package path: source}, whether the case plants a violation)
FIXTURES = [
    ("cfg_typo_and_dead_key", "CFG", {CFG_ALGO: JAX.CFG_YAML, "sheeprl_tpu/foo.py": JAX.CFG_CONSUMER}, True),
    ("cfg_typo_in_root_and_middle", "CFG", {
        CFG_ALGO: "name: test\nnested:\n  used: 1\n",
        "sheeprl_tpu/foo.py": "def main(cfg):\n    a = cfg.algo.name\n    b = cfg.algoo.name\n"
                              "    c = cfg.algo.nseted.used\n"}, True),
    ("cfg_alias_typo_and_get_exemption", "CFG", {
        CFG_ALGO: "name: test\nlr: 0.5\n",
        "sheeprl_tpu/foo.py": "def main(cfg):\n    algo_cfg = cfg.algo\n    a = algo_cfg.lr\n    b = algo_cfg.lrr\n"
                              "    opt_cfg = cfg.get('algo') or {}\n    c = opt_cfg.whatever\n"}, True),
    ("cfg_subsection_param", "CFG", {
        CFG_ALGO: "name: test\ndense_units: 8\n",
        "sheeprl_tpu/foo.py": "def build(cfg):\n    return cfg.dense_units, cfg.activation\n"}, True),
    ("cfg_defined_keys_clean", "CFG", {
        CFG_ALGO: "name: test\nlr: 0.5\n",
        "sheeprl_tpu/foo.py": "def main(cfg):\n    return cfg.algo.lr, cfg.algo.name\n"}, False),
    ("cfg_yaml11_bool", "CFG", {"sheeprl_tpu/configs/env/default.yaml": 'id: x\nmode: off\nquoted: "off"\n'}, True),
    ("cfg_mounted_group", "CFG", {
        CFG_ALGO: "defaults:\n  - /optim@optimizer: adam\nname: test\n",
        "sheeprl_tpu/configs/optim/adam.yaml": "_target_: optax.adam\nlearning_rate: 2e-4\n",
        "sheeprl_tpu/foo.py": "def main(cfg):\n    opt = instantiate(cfg.algo.optimizer)\n"
                              "    return opt, cfg.algo.name\n"}, False),
    ("jrn_unregistered_kind_and_metric", "JRN", _jrn(_JRN_EMIT_POSITIVE), True),
    ("jrn_registered_clean", "JRN", _jrn(_JRN_EMIT_NEGATIVE), False),
    ("jrn_attribute_journal_write", "JRN", _jrn(_JRN_EMIT_ATTRIBUTE), True),
    ("jrn_serving_emitters", "JRN", _jrn(_JRN_SERVING, path="sheeprl_tpu/serving/server.py"), True),
    ("jrn_doc_table_sync", "JRN",
     _jrn(_JRN_EMIT_OK, doc=JAX.JRN_DOC_OK.replace("`ok_event`", "`something_else_entirely`")), True),
    ("asy_double_async_and_foreign_cmd_byte", "ASY", {X: _ASY_DOUBLE}, True),
    ("asy_prime_then_wait_at_top", "ASY", {X: _ASY_PRIME_WAIT_TOP, "sheeprl_tpu/envs/executor.py": '_CMD_STEP = b"S"\n'},
     False),
    ("asy_async_with_no_wait", "ASY", {X: "def loop(envs, a):\n    for _ in range(3):\n        envs.step_async(a)\n"},
     True),
    ("asy_prime_then_loop_async_first", "ASY", {X: _ASY_PRIME_THEN_LOOP}, True),
    ("asy_two_receivers", "ASY", {X: _ASY_TWO_RECEIVERS}, False),
    ("asy_nested_helper", "ASY", {X: _ASY_NESTED_HELPER}, False),
    ("asy_line_free_messages", "ASY", {X: _ASY_LINE_MESSAGES}, True),
    ("trc_unknown_span_name", "TRC", _trc({"sheeprl_tpu/serving/batcher.py": _TRC_UNKNOWN}), True),
    ("trc_known_and_dynamic_clean", "TRC", _trc({"sheeprl_tpu/serving/server.py": _TRC_CLEAN}), False),
    ("trc502_inline_buckets", "TRC", _trc({"sheeprl_tpu/serving/server.py": _TRC502_INLINE}), True),
    ("trc502_config_buckets", "TRC", _trc({"sheeprl_tpu/serving/server.py": _TRC502_CONFIG}), False),
    ("trc502_outside_serving", "TRC", _trc({"sheeprl_tpu/diagnostics/foo.py": "buckets_ms = [1, 2, 3]\n"}), False),
    ("trc_missing_registry", "TRC", {"sheeprl_tpu/serving/server.py": "x = 1\n"}, True),
    ("lck501_racy", "LCK", {WORKER: JAX.LCK501_RACY}, True),
    ("lck501_guarded", "LCK", {WORKER: JAX.LCK501_GUARDED}, False),
    ("lck501_main_only_publication", "LCK", {"sheeprl_tpu/diagnostics/facade.py": _LCK_MAIN_ONLY}, False),
    ("lck502_escaped_write", "LCK", {WORKER: JAX.LCK502_ESCAPED}, True),
    ("lck502_escaped_read", "LCK",
     {WORKER: JAX.LCK502_ESCAPED.replace("    def reset(self):\n        self.count = 0\n\n", "")}, False),
    ("lck502_extra_lock", "LCK", {WORKER: _LCK_EXTRA_LOCK}, False),
    ("lck503_unlocked_journal", "LCK", {"sheeprl_tpu/diagnostics/journal.py": _LCK503_BAD}, True),
    ("lck503_locked_api", "LCK", {"sheeprl_tpu/diagnostics/journal.py": _LCK503_GOOD}, False),
    ("lck504_blocking_under_lock", "LCK", {"sheeprl_tpu/diagnostics/mon.py": _LCK504_BAD}, True),
    ("lck504_uncontended", "LCK", {"sheeprl_tpu/diagnostics/health2.py": _LCK504_UNCONTENDED}, False),
    ("lck504_outside_lock", "LCK", {"sheeprl_tpu/diagnostics/mon.py": _LCK504_OUTSIDE}, False),
    ("lck505_unbounded_waits", "LCK", {"sheeprl_tpu/serving/waiter.py": _LCK505_BAD}, True),
    ("lck505_bounded_waits", "LCK", {"sheeprl_tpu/serving/waiter.py": _LCK505_GOOD}, False),
]

_JAX_PASSES = {"CFG": JAX.cfg_pass, "JRN": JAX.jrn_pass, "ASY": JAX.asy_pass, "TRC": JAX.trc_pass, "LCK": JAX.lck_pass}
_PORT_PASSES = {"CFG": cfg_pass, "JRN": jrn_pass, "ASY": asy_pass, "TRC": trc_pass, "LCK": lck_pass}


def _to_port(files):
    return {path.replace("sheeprl_tpu/", "sheeprl_tpu_torch/", 1): src for path, src in files.items()}


@pytest.mark.parametrize("family, files, planted", [pytest.param(*case[1:], id=case[0]) for case in FIXTURES])
def test_the_jax_fixtures_give_the_same_rules_through_both_passes(family, files, planted):
    jax_rules = Counter(f.rule for f in _JAX_PASSES[family].run(JAX.RepoIndex.from_sources(files)))
    port_findings = _PORT_PASSES[family].run(RepoIndex.from_sources(_to_port(files)))
    assert Counter(f.rule for f in port_findings) == jax_rules
    assert bool(jax_rules) == planted
    # the port's messages name the port's files, and carry no line numbers
    for finding in port_findings:
        assert finding.file.startswith(("sheeprl_tpu_torch/", "howto/")), finding
        assert not re.search(r"line \d", finding.message), finding.message


# -- red mutations on the port's own sources, one per LCK rule ---------------

def _mutated(relpath: str, old: str, new: str) -> RepoIndex:
    source = (ROOT / relpath).read_text()
    assert old in source, f"mutation anchor vanished from {relpath}: {old!r}"
    return RepoIndex.from_sources({relpath: source.replace(old, new)})


@pytest.mark.parametrize("rule, relpath, old, new", [
    ("LCK502", "sheeprl_tpu_torch/serving/request_log.py",
     "with self._lock:\n                    self._error = err", "if True:\n                    self._error = err"),
    ("LCK501", "sheeprl_tpu_torch/serving/server.py", "with self._steps_lock:", "if True:"),
    ("LCK502", "sheeprl_tpu_torch/diagnostics/goodput.py",
     "with self._lock:\n            now = self._clock()\n            self._last_progress = now",
     "if True:\n            now = self._clock()\n            self._last_progress = now"),
    ("LCK503", "sheeprl_tpu_torch/diagnostics/journal.py", "with self._lock:", "if True:"),
    ("LCK504", "sheeprl_tpu_torch/resilience/async_writer.py", "self.failed_total += 1",
     "self.failed_total += 1; time.sleep(0.5)"),
    ("LCK505", "sheeprl_tpu_torch/diagnostics/goodput.py", "self._stop.wait(self.heartbeat_s)", "self._stop.wait()"),
])
def test_unguarding_the_ports_threads_goes_red(rule, relpath, old, new):
    """Each mutation of the port's real sources trips its rule, outside the
    shipped baseline; the unmutated file lints clean under it."""
    baseline = load_baseline(str(BASELINE))
    clean, _, _ = apply_baseline(lck_pass.run(RepoIndex.from_sources({relpath: (ROOT / relpath).read_text()})),
                                 baseline)
    assert clean == []
    active, _, _ = apply_baseline(lck_pass.run(_mutated(relpath, old, new)), baseline)
    assert rule in {f.rule for f in active}


# ---------------------------------------------------------------------------
# INS: the flagship map of the shared loops
# ---------------------------------------------------------------------------

ON_POLICY = """\
def make_update(agent, optimizer, cfg):
    train_step = make_train_step(agent, optimizer, cfg)   # the raw step, inside the builder
    def update(iter_num, data, generator):
        return train_step(data)
    return update

def make_train_step(agent, optimizer, cfg):
    def step(data):
        stats = health_stats(data, data, data)
        return stats
    return step

def _on_policy_main(runtime, cfg, make_update_fn):
    diag = runtime.diagnostics
    train_step = diag.instrument("train_step", make_update_fn(None, None, cfg), kind="train")
    policy = diag.instrument("policy_step", None, kind="rollout")
"""
OFF_POLICY = """\
def make_train_step(agent, optimizers, cfg):
    def update(data):
        return health_stats(data, data, data)
    return update

def off_policy_main(runtime, cfg, family):
    family.update = diag.instrument("train_step", family.update, kind="train")
    family.act = diag.instrument("policy_step", family.act, kind="rollout")
"""
DREAMER = """\
def make_train_step(agent, optimizers, cfg):
    def step(data):
        return health_stats(data, data, data)
    return step

def _dreamer_main(runtime, cfg):
    train_step = diag.instrument("train_step", make_train_step(None, None, cfg), kind="train")
"""
OFFLINE = """\
def _offline_flat(runtime, cfg):
    update = diag.instrument("train_step", family.update, kind="train")
"""
A2C = """\
def make_train_step(agent, optimizer, cfg):
    def update(data):
        return health_stats(data, data, data)
    return update
"""
DECOUPLED = """\
@register_algorithm(decoupled=True)
def main(runtime, cfg):
    train_step = diag.instrument("train_step", update, kind="train")
    policy = diag.instrument("policy_step", None, kind="rollout")
"""


def _flagships(**replace):
    files = {"algos/ppo/ppo.py": ON_POLICY, "algos/sac/sac.py": OFF_POLICY, "algos/dreamer_v3/dreamer_v3.py": DREAMER,
             "offline/train.py": OFFLINE, "algos/a2c/a2c.py": A2C, "algos/ppo/ppo_decoupled.py": DECOUPLED,
             "algos/sac/sac_decoupled.py": DECOUPLED}
    files.update(replace)
    return RepoIndex.from_sources({f"sheeprl_tpu_torch/{k}": v for k, v in files.items() if v is not None})


@pytest.mark.parametrize("replace, expected", [
    ({}, []),
    # the rollout instrument dropped from the on-policy loop
    ({"algos/ppo/ppo.py": ON_POLICY.replace('    policy = diag.instrument("policy_step", None, kind="rollout")\n', "")},
     ["INS005"]),
    # the loop's step assigned without the instrument
    ({"algos/dreamer_v3/dreamer_v3.py": DREAMER.replace('diag.instrument("train_step", make_train_step(None, None, cfg), '
                                                        'kind="train")', "make_train_step(None, None, cfg)")},
     ["INS002", "INS004"]),
    # an instrument call outside the flagship function does not count
    ({"algos/sac/sac.py": OFF_POLICY.replace("def off_policy_main(runtime, cfg, family):",
                                             "def helper(family):\n    pass\n\ndef off_policy_main(runtime, cfg, family):\n"
                                             "    pass\n\ndef elsewhere(runtime, cfg, family):")},
     ["INS004", "INS005"]),
    # a loop moved away, a whole flagship file gone
    ({"algos/dreamer_v3/dreamer_v3.py": DREAMER.replace("_dreamer_main", "_renamed_main")}, ["INS006"]),
    ({"offline/train.py": None}, ["INS006"]),
    # a guarded builder without the health hook
    ({"algos/a2c/a2c.py": A2C.replace("return health_stats(data, data, data)", "return data")}, ["INS007"]),
    # donation has no eager counterpart: an instrument without donate_argnums is clean
    ({"algos/ppo/ppo.py": ON_POLICY.replace('kind="train")', 'kind="train", cost_note="x")')}, []),
])
def test_ins_follows_the_ports_shared_loops(replace, expected):
    assert sorted(f.rule for f in ins_pass.run(_flagships(**replace))) == expected


def test_ins001_and_ins003_are_listed_as_not_applicable():
    for rule in ("INS001", "INS003"):
        assert "not applicable to the port" in ins_pass.RULES[rule]
    # a jit in a builder without donation, as the JAX fixture plants it, stays silent here
    index = RepoIndex.from_sources({"sheeprl_tpu_torch/algos/newalgo/newalgo.py": JAX.BAD_ALGO})
    assert not {"INS001", "INS003"} & {f.rule for f in ins_pass.run(index)}


# ---------------------------------------------------------------------------
# JIT: the step bodies
# ---------------------------------------------------------------------------

INSTRUMENTED_SYNC = """\
import torch

def policy_forward(obs, generator):
    actions = obs["state"].argmax(-1)
    return actions.item()

def main(diag):
    step = diag.instrument("policy_step", policy_forward, kind="rollout")
"""

IMPURE_BUILDER = """\
import random
import time
import numpy as np
import torch

def loss_fn(params, batch):
    t0 = time.perf_counter()
    return (params - batch).sum()

def make_update(agent, cfg):
    def update(data, generator, scale: float):
        noise = np.random.normal(size=3)
        eps = torch.randn(3)
        data["x"].uniform_(0, 1)
        pick = random.choice([0, 1])
        print("step")
        n = int(data)
        torch.cuda.synchronize()
        host = data["x"].cpu()
        rows = data["x"].tolist()
        return loss_fn(data, data) * float(scale)
    return update
"""

PURE = """\
import time
import numpy as np
import torch

def make_train_step(agent, cfg):
    def update(data, generator, iters: int):
        eps = torch.randn(3, generator=generator)
        data["x"].normal_(generator=generator)
        return data["x"].sum() * int(iters)
    return update

def host_loop(envs, train_step):
    t0 = time.time()                 # host code: clocks, prints and fetches are fine here
    print("iter", t0)
    return train_step(np.zeros(3)).item()
"""


def test_a_sync_planted_in_an_instrumented_function_is_found():
    findings = jit_pass.run(RepoIndex.from_sources({"sheeprl_tpu_torch/algos/x/x.py": INSTRUMENTED_SYNC}))
    assert [f.rule for f in findings] == ["JIT103"]
    assert "`.item()`" in findings[0].message and "policy_forward" in findings[0].message


def test_a_builders_step_and_its_closure_are_held_to_every_rule():
    findings = jit_pass.run(RepoIndex.from_sources({"sheeprl_tpu_torch/algos/x/x.py": IMPURE_BUILDER}))
    assert Counter(f.rule for f in findings) == Counter(
        {"JIT101": 4, "JIT102": 1, "JIT103": 3, "JIT104": 1, "JIT105": 1})
    # the wall clock sits in loss_fn, reached through the step's closure;
    # float() of a parameter annotated `float` is a host value
    assert any(f.rule == "JIT102" and "loss_fn" in f.message for f in findings)
    assert not any("float(scale)" in f.message for f in findings)


def test_host_code_and_explicit_generators_stay_clean():
    assert jit_pass.run(RepoIndex.from_sources({"sheeprl_tpu_torch/algos/x/x.py": PURE})) == []


# ---------------------------------------------------------------------------
# the entry point on the real tree, and on planted fixtures
# ---------------------------------------------------------------------------

def test_the_port_lints_clean_within_budget(tmp_path):
    out = tmp_path / "report.json"
    t0 = time.monotonic()
    result = subprocess.run([*LINT, "--format", "json", "--out", str(out)], capture_output=True, text=True,
                            timeout=60, cwd=ROOT)
    elapsed = time.monotonic() - t0
    assert result.returncode == 0, result.stdout[-3000:] + result.stderr[-3000:]
    assert elapsed < 15.0, f"lint took {elapsed:.1f}s (budget 15s)"
    report = json.loads(out.read_text())
    assert report["findings"] == [] and report["stale_baseline_entries"] == []
    assert set(report["families"]) == FAMILIES
    assert report["suppressed"] == len(json.loads(BASELINE.read_text())["entries"])


_PLANTED = {
    "INS": {"sheeprl_tpu_torch/algos/ppo/ppo.py": "def _on_policy_main(cfg):\n    train_step = make(cfg)\n"},
    "JIT": {"sheeprl_tpu_torch/algos/x/x.py": INSTRUMENTED_SYNC},
    "CFG": {"sheeprl_tpu_torch/configs/env/default.yaml": "id: x\nmode: off\n"},
    "JRN": {"sheeprl_tpu_torch/diagnostics/schema.py": JAX.JRN_SCHEMA,
            "sheeprl_tpu_torch/diagnostics/emitter.py": _JRN_EMIT_POSITIVE, "howto/diagnostics.md": JAX.JRN_DOC_OK},
    "ASY": {"sheeprl_tpu_torch/algos/x/x.py": _ASY_DOUBLE},
    "TRC": {"sheeprl_tpu_torch/diagnostics/tracing.py": JAX.TRC_TRACING,
            "sheeprl_tpu_torch/serving/batcher.py": _TRC_UNKNOWN},
    "LCK": {"sheeprl_tpu_torch/serving/worker.py": JAX.LCK501_RACY},
}


@pytest.mark.parametrize("family", sorted(_PLANTED))
def test_the_entry_point_fails_on_each_planted_fixture(family, tmp_path):
    for rel, src in _PLANTED[family].items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(src)
    result = subprocess.run([*LINT, "--root", str(tmp_path), "--rules", family, "--baseline",
                             str(tmp_path / "none.json")], capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert result.returncode == 1, result.stdout + result.stderr
    assert f"· {family}" in result.stdout and "FAIL" in result.stdout


def test_the_rule_catalog_lists_every_family():
    result = subprocess.run([*LINT, "--list-rules"], capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert result.returncode == 0
    listed = {line.split()[0] for line in result.stdout.splitlines() if line.strip()}
    assert {port_lint.rule_family(r) for r in listed} == FAMILIES
    assert set(port_lint.rule_catalog()) == listed


def test_rules_subset_and_parallel_families_match_a_sequential_run():
    index = RepoIndex.from_sources({"sheeprl_tpu_torch/serving/worker.py": JAX.LCK501_RACY,
                                    "sheeprl_tpu_torch/configs/algo/default.yaml": JAX.CFG_YAML,
                                    "sheeprl_tpu_torch/foo.py": JAX.CFG_CONSUMER})
    sequential = run_passes(index)
    assert run_passes(index, jobs=4) == sequential
    assert {f.rule for f in run_passes(index, families=["LCK"], jobs=4)} == {"LCK501"}


# ---------------------------------------------------------------------------
# the baseline
# ---------------------------------------------------------------------------

def test_the_baseline_round_trips(tmp_path):
    finding = Finding("CFG202", "warning", "a.yaml", 3, "config key `x` is dead")
    other = Finding("JIT102", "error", "b.py", 9, "wall clock")
    path = str(tmp_path / "baseline.json")
    assert write_baseline(path, [finding], {}) == 1
    baseline = load_baseline(path)
    active, suppressed, stale = apply_baseline([finding, other], baseline)
    assert active == [other] and suppressed == [finding] and stale == []
    # line drift keeps the suppression; a changed message does not
    moved = Finding("CFG202", "warning", "a.yaml", 99, "config key `x` is dead")
    assert apply_baseline([moved], baseline)[0] == []
    changed = Finding("CFG202", "warning", "a.yaml", 3, "config key `y` is dead")
    active, _, stale = apply_baseline([changed], baseline)
    assert active == [changed] and len(stale) == 1
    # a rewrite keeps a hand-written why
    entry = json.loads(Path(path).read_text())["entries"][0]
    entry["why"] = "kept on purpose"
    Path(path).write_text(json.dumps({"entries": [entry]}))
    assert write_baseline(path, [finding], load_baseline(path)) == 0
    assert json.loads(Path(path).read_text())["entries"][0]["why"] == "kept on purpose"


def test_update_baseline_with_a_rules_subset_keeps_the_other_families(tmp_path):
    baseline = tmp_path / "baseline.json"
    baseline.write_text(BASELINE.read_text())
    result = subprocess.run([*LINT, "--rules", "JIT", "--baseline", str(baseline), "--update-baseline"],
                            capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert result.returncode == 0, result.stdout + result.stderr
    assert json.loads(baseline.read_text())["entries"] == json.loads(BASELINE.read_text())["entries"]


def test_every_baseline_entry_has_a_one_line_why():
    entries = json.loads(BASELINE.read_text())["entries"]
    assert entries
    for entry in entries:
        why = entry.get("why", "")
        assert why and not why.startswith("TODO") and "\n" not in why, entry
        assert entry["file"].startswith("sheeprl_tpu_torch/"), entry


# ---------------------------------------------------------------------------
# every config key the JAX package reads has a port reader
# ---------------------------------------------------------------------------

#: the keys the JAX package reads as ``cfg.<path>`` that the harvest finds no
#: port access of: (port file:line, a text of that line) where the port
#: reads it through an alias the harvest cannot follow, or refuses it
PORT_READERS = {
    "algo.actor.clip_gradients": ("algos/dreamer_v3/dreamer_v3.py:390", "section.clip_gradients"),
    "algo.critic.clip_gradients": ("algos/dreamer_v3/dreamer_v3.py:390", "section.clip_gradients"),
    "algo.world_model.clip_gradients": ("algos/dreamer_v3/dreamer_v3.py:390", "section.clip_gradients"),
    "algo.ensembles.clip_gradients": ("algos/dreamer_v3/dreamer_v3.py:128", "section.clip_gradients"),
    "algo.world_model.optimizer": ("algos/dreamer_v3/dreamer_v3.py:97", "instantiate(section.optimizer)"),
    "algo.ensembles.optimizer": ("algos/dreamer_v3/dreamer_v3.py:97", "instantiate(section.optimizer)"),
    "algo.actor.moments.decay": ("algos/dreamer_v3/dreamer_v3.py:297", "m.decay"),
    "algo.actor.moments.max": ("algos/dreamer_v3/dreamer_v3.py:297", "m.max"),
    "algo.actor.moments.percentile": ("algos/dreamer_v3/dreamer_v3.py:297", "m.percentile"),
    "algo.actor.moments.percentile.low": ("algos/dreamer_v3/dreamer_v3.py:297", "m.percentile.low"),
    "algo.actor.moments.percentile.high": ("algos/dreamer_v3/dreamer_v3.py:298", "m.percentile.high"),
    "algo.encoder.cnn_channels_multiplier": ("algos/sac_ae/agent.py:188", "enc_cfg.cnn_channels_multiplier"),
    "algo.encoder.dense_units": ("algos/sac_ae/agent.py:188", "enc_cfg.dense_units"),
    "algo.encoder.mlp_layers": ("algos/sac_ae/agent.py:188", "enc_cfg.mlp_layers"),
    "algo.encoder.features_dim": ("algos/sac_ae/agent.py:187", "enc_cfg.features_dim"),
    "algo.encoder.optimizer": ("algos/sac_ae/sac_ae.py:190", "algo.encoder.optimizer"),
    "algo.decoder.cnn_channels_multiplier": ("algos/sac_ae/agent.py:194", "dec_cfg.cnn_channels_multiplier"),
    "algo.decoder.dense_units": ("algos/sac_ae/agent.py:194", "dec_cfg.dense_units"),
    "algo.decoder.mlp_layers": ("algos/sac_ae/agent.py:194", "dec_cfg.mlp_layers"),
    "algo.decoder.optimizer": ("algos/sac_ae/sac_ae.py:191", "algo.decoder.optimizer"),
    "algo.ensembles.n": ("algos/p2e_dv1/agent.py:68", "ens_cfg.n"),
    "algo.ensembles.dense_units": ("algos/p2e_dv1/agent.py:69", "ens_cfg.dense_units"),
    "algo.ensembles.mlp_layers": ("algos/p2e_dv1/agent.py:69", "ens_cfg.mlp_layers"),
    # instantiate(cfg.algo.optimizer) maps learning_rate to torch's lr
    "algo.optimizer.learning_rate": ("algos/ppo/ppo.py:317", 'optimizer.param_groups[0]["lr"]'),
    # read and ignored: XLA lowering choices eager PyTorch has not got
    "algo.rssm_pallas": ("models/blocks.py:121", "algo.rssm_pallas"),
    "algo.world_model.recurrent_model.fused_kernel": ("models/blocks.py:122", "recurrent_model.fused_kernel"),
    "algo.scan_unroll": ("models/blocks.py:123", "algo.scan_unroll"),
    # the harvest reads a list's and a string's methods as keys
    "batch_buckets.append": ("serving/server.py:270", 'cfg.get("batch_buckets")'),
    "buffer.type.lower": ("algos/dreamer_v3/dreamer_v3.py:787", 'cfg.buffer.get("type")'),
    "diagnostics.resilience.isolation.max_staleness": ("resilience/isolation.py:83", '"max_staleness"'),
    "diagnostics.resilience.isolation.retry_budget": ("resilience/isolation.py:84", '"retry_budget"'),
    "diagnostics.resilience.isolation.refresh_every": ("resilience/isolation.py:86", '"refresh_every"'),
    "metric.logger.root_dir": ("cli.py:565", '("root_dir", "save_dir")'),
    "metric.logger.save_dir": ("cli.py:565", '("root_dir", "save_dir")'),
}


def _cfg_reads(package: str):
    files = {p.relative_to(ROOT).as_posix(): p.read_text()
             for p in sorted((ROOT / package).rglob("*.py")) if "__pycache__" not in p.parts}
    harvest = cfg_pass.PyHarvest()
    for rel, tree in RepoIndex.from_sources(files).modules():
        harvest.scan_module(tree, rel)
    return {".".join(path) for path, *_ in harvest.accesses}


def test_every_config_key_the_jax_package_reads_has_a_port_reader():
    missing = _cfg_reads("sheeprl_tpu") - _cfg_reads("sheeprl_tpu_torch")
    assert missing == set(PORT_READERS), sorted(missing ^ set(PORT_READERS))
    for key, (where, text) in sorted(PORT_READERS.items()):
        rel, line = where.rsplit(":", 1)
        lines = (ROOT / "sheeprl_tpu_torch" / rel).read_text().splitlines()
        # a few lines of drift are fine; the reader must still be there
        window = lines[max(0, int(line) - 6):int(line) + 5]
        assert any(text in ln for ln in window), f"{key}: {text!r} not near {where}"


def test_the_lint_package_parses_as_the_lint_sees_it():
    """The lint's own modules are in the tree it lints, and parse."""
    index = RepoIndex.from_fs(ROOT)
    names = {p for p, _ in index.modules("sheeprl_tpu_torch/tools/lint/")}
    assert {f"sheeprl_tpu_torch/tools/lint/{m}.py" for m in
            ("__init__", "loader", "cfg_pass", "jrn_pass", "trc_pass", "asy_pass", "lck_pass", "ins_pass",
             "jit_pass")} <= names
    assert index.parse_errors == []
    assert all(isinstance(index.module(p), ast.Module) for p in names)
