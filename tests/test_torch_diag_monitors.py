"""The port's diagnostics vocabulary and host-side monitors against the JAX
package, on the CPU: the journal's event kinds and gauge names, every
journal emission in the port registered (the AST walk of the JAX lint's JRN
pass), the peak table and the MFU formula, the FLOP count of a gradient step
through the kernel's registered formula, and ``DivergenceDetector``,
``HealthMonitor`` and ``GoodputMonitor`` fed one sequence of metric rows and
hooks under a fake clock, journaling what the JAX classes journal."""

from __future__ import annotations

import ast
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from sheeprl_tpu.diagnostics import schema as jax_schema
from sheeprl_tpu.diagnostics.goodput import GoodputMonitor as JaxGoodputMonitor
from sheeprl_tpu.diagnostics.health import HealthMonitor as JaxHealthMonitor
from sheeprl_tpu.diagnostics.sentinel import DivergenceDetector as JaxDivergenceDetector
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_optimizers, make_train_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments_state
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.diagnostics import schema
from sheeprl_tpu_torch.diagnostics.goodput import GoodputMonitor
from sheeprl_tpu_torch.diagnostics.health import HealthMonitor
from sheeprl_tpu_torch.diagnostics.sentinel import DivergenceDetector
from sheeprl_tpu_torch.diagnostics.telemetry import Telemetry, count_flops, resolve_peak_flops
from sheeprl_tpu_torch.models import blocks
from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru, ln_gru_reference
from test_torch_dv3_train import OBS_SPACE, REC, TINY, B, T, _batch, _Setup
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

PORT = Path(__file__).resolve().parents[1] / "sheeprl_tpu_torch"
EMITTERS = {"_journal", "_journal_event", "_journal_synced"}


def test_the_wire_vocabulary_is_the_jax_packages():
    assert schema.EVENT_KINDS == jax_schema.EVENT_KINDS
    assert schema.METRICS == jax_schema.METRICS
    assert schema.METRIC_PREFIX == jax_schema.METRIC_PREFIX


def _emitted_kinds():
    """``(kind, file, line)`` of every journal emission with a literal kind
    in the port: ``journal.write("<kind>")`` and the pillars' ``_journal*``
    forwarders, as the JRN lint pass finds them."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args or not isinstance(node.func, (ast.Attribute, ast.Name)):
                continue
            name = node.func.attr if isinstance(node.func, ast.Attribute) else node.func.id
            emitter = name in EMITTERS
            if name == "write" and isinstance(node.func, ast.Attribute):
                recv = node.func.value
                emitter = (recv.id if isinstance(recv, ast.Name) else getattr(recv, "attr", "")) in ("journal",
                                                                                                       "_journal")
            first = node.args[0]
            if emitter and isinstance(first, ast.Constant) and isinstance(first.value, str):
                out.append((first.value, path.relative_to(PORT.parent), node.lineno))
    return out


def test_every_journal_emission_of_the_port_is_a_registered_kind():
    emitted = _emitted_kinds()
    kinds = {k for k, _, _ in emitted}
    # the loop's and the facade's own events are all there
    assert {"run_start", "run_end", "metrics", "checkpoint", "ckpt_begin", "ckpt_end", "preempted", "divergence",
            "anomaly", "state_change", "stall", "telemetry_cost", "recompile", "host_transfer", "oom",
            "memory_breakdown"} <= kinds
    unregistered = [(k, str(f), n) for k, f, n in emitted if k not in schema.EVENT_KINDS]
    assert not unregistered


def test_every_telemetry_gauge_literal_of_the_port_is_registered():
    from sheeprl_tpu_torch.diagnostics.metrics_server import _metric_name

    found = set()
    for path in sorted((PORT / "diagnostics").glob("*.py")) + sorted((PORT / "resilience").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            name = None
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.startswith("Telemetry/"):
                name = node.value
            elif (isinstance(node, ast.BinOp) and isinstance(node.left, ast.Name) and node.left.id == "TELEMETRY_PREFIX"
                  and isinstance(node.right, ast.Constant)):
                name = "Telemetry/" + node.right.value
            # whole gauge names (prefixes of built names end in "/")
            if name is not None and name.count("/") == 1 and name[-1] != "/":
                found.add(name)
    assert {"Telemetry/mfu", "Telemetry/hbm_bytes_in_use", "Telemetry/ckpt_last_step"} <= found
    missing = [n for n in found if schema.METRIC_PREFIX + _metric_name(n) not in schema.METRICS]
    assert not missing


def test_peak_table_and_the_mfu_formula():
    assert resolve_peak_flops("NVIDIA H100 80GB HBM3", "32-true") == 66.9e12
    assert resolve_peak_flops("NVIDIA H100 80GB HBM3", "bf16-mixed") == 989.4e12
    assert resolve_peak_flops("NVIDIA H100 80GB HBM3", "bf16-true") == 989.4e12
    assert resolve_peak_flops("cpu", "32-true") is None
    assert resolve_peak_flops("NVIDIA A100-SXM4-80GB", "bf16-mixed") is None

    clock = [0.0]
    cfg = {"diagnostics": {"telemetry": {"mfu": {"peak_tflops_per_device": 1.0}}}, "fabric": {"precision": "32-true"}}
    tele = Telemetry(cfg, clock=lambda: clock[0])
    tele.open(None, {}, device="cpu")
    tele.interval_metrics(step=0)
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    step = tele.instrument("train_step", lambda x, y: x @ y, kind="train")
    for _ in range(3):
        step(a, b)
    clock[0] = 2.0
    gauges = tele.interval_metrics(step=40)
    flops = 3 * 2 * 8 * 16 * 4  # FLOPs of the step over the interval's wall clock, over the peak
    assert gauges["Telemetry/tflops_per_sec"] == pytest.approx(flops / 2.0 / 1e12)
    assert gauges["Telemetry/mfu"] == pytest.approx(flops / 2.0 / 1e12)
    assert gauges["Telemetry/sps"] == pytest.approx(20.0)
    # no peak for the CPU: throughput, never an MFU against a guessed peak
    cpu = Telemetry({"fabric": {"precision": "32-true"}}, clock=lambda: clock[0])
    cpu.open(None, {}, device="cpu")
    cpu.instrument("train_step", lambda x, y: x @ y, kind="train")(a, b)
    clock[0] = 4.0
    assert "Telemetry/mfu" not in cpu.interval_metrics(step=8)


def test_a_gradient_steps_flops_count_the_kernel_by_its_registered_formula():
    """The cell as the kernel's operator counts by its registered formula
    (its plain product on the CPU unseen), which equals the plain version's
    product as ``FlopCounterMode`` counts it; so the card's count, where the
    kernel is a ``ctypes`` launch, is the CPU's.  A test-width step through
    the kernel's ``autograd.Function`` then counts what the step through
    the plain version counts, plus the backward's recompute of the cell in
    the dynamic scan (T calls at B rows; imagination's cells get no
    backward with discrete actions)."""
    rng = np.random.default_rng(0)
    K, H3, rows = 16, 24, 2
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((rows, K), (H3, K), (H3,), (H3,), (H3,),
                                                                                (rows, H3 // 3))]
    kernel = count_flops(lambda: fused_layernorm_gru(*args, 1e-3))
    plain = count_flops(lambda: ln_gru_reference(*args, 1e-3))
    assert kernel[1] == plain[1] == 2 * rows * K * H3
    torch.testing.assert_close(kernel[0], plain[0])

    setup = _Setup("multidiscrete_dummy", (2, 2), False)
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in _batch(setup, 3).items()}
    counts = []
    for use_plain in (False, True):
        agent = setup.agent()
        step = make_train_step(agent, make_optimizers(setup.cfg, agent), setup.cfg, False)
        gen = torch.Generator().manual_seed(0)
        with mock.patch.object(blocks, "fused_layernorm_gru", ln_gru_reference) if use_plain else mock.MagicMock():
            counts.append(count_flops(lambda: step(init_moments_state(), batch, 0.02, gen))[1])
    joint = REC + setup.cfg.algo.world_model.recurrent_model.dense_units
    assert counts[0] == counts[1] + T * 2 * B * joint * 3 * REC > counts[1] > 0


# ---------------------------------------------------------------------------
# host-side monitors, port and JAX, on one sequence


def _health_cfg():
    return {"diagnostics": {"enabled": True, "health": {
        "enabled": True, "per_module": True, "confirm": 2,
        "detectors": {"entropy_key": "Loss/entropy_loss", "entropy_floor": 0.05, "update_ratio_low": 1e-8,
                      "update_ratio_high": 1.0, "dead_frac_max": 0.9, "plateau_key": "Loss/value_loss",
                      "plateau_window": 4, "plateau_rtol": 1e-3, "value_ev_floor": 0.1}}}}


def _drive_health(cls):
    events = []
    mon = cls(_health_cfg())
    mon.open(lambda e, **f: events.append((e, f)), lambda: None)
    gauges = []
    for step in range(1, 13):
        ratio = 2.0 if 3 <= step <= 6 else 1e-3
        dead = 0.95 if 5 <= step <= 8 else 0.1
        mon.on_stats(step, {"grad_norm": 1.0, "update_norm": ratio, "param_norm": 1.0, "update_ratio": ratio,
                            "dead_frac": dead, "module/actor/dead_frac": dead, "value_ev": 0.05 if step > 9 else 0.5})
        mon.observe_metrics(step, {"Loss/entropy_loss": 0.01 if 4 <= step <= 7 else 0.5,
                                   "Loss/value_loss": 1.0 if step > 6 else float(step)})
        gauges.append(mon.interval_metrics())
    return events, gauges, mon.summary()


def test_health_monitor_journals_what_the_jax_one_does():
    got, want = _drive_health(HealthMonitor), _drive_health(JaxHealthMonitor)
    assert [e for e, _ in got[0]] == [e for e, _ in want[0]]
    assert {e for e, _ in got[0]} >= {"anomaly", "anomaly_end"}
    assert got == want


def _drive_divergence(cls):
    det = cls(window=6, min_points=3, loss_explosion_ratio=10.0, entropy_key="Loss/entropy_loss",
              entropy_floor=0.05)
    out = []
    for step, (loss, ent) in enumerate([(1.0, 0.5), (1.1, 0.4), (0.9, 0.3), (1.0, 0.02), (50.0, 0.3), (float("nan"), 0.3),
                                        (1.0, 0.3), (float("inf"), 0.01)]):
        out.append(det.observe(step, {"Loss/world_model_loss": loss, "Loss/entropy_loss": ent, "Other": 1.0}))
    return out


def test_divergence_detector_flags_what_the_jax_one_does():
    got = _drive_divergence(DivergenceDetector)
    assert repr(got) == repr(_drive_divergence(JaxDivergenceDetector))  # NaN != NaN: compared as text
    assert any(got)


class _FakeTelemetry:
    def __init__(self):
        self.seconds = 0.0

    def train_seconds(self):
        return self.seconds


def _drive_goodput(cls):
    clock = [100.0]
    events = []
    cfg = {"diagnostics": {"goodput": {"watchdog": {"enabled": False, "heartbeat_s": 1.0, "stall_threshold_s": 5.0,
                                                    "compile_grace": 3.0}}}}
    tele = _FakeTelemetry()
    mon = cls(cfg, clock=lambda: clock[0])
    mon.open(lambda e, **f: events.append((e, {k: v for k, v in f.items() if k != "stacks"})), lambda: None,
             telemetry=tele, log_dir=None)
    gauges = []
    for name, dt, hook in [("compile", 4.0, lambda: mon.note_compile_start("ln_gru")),
                           ("rollout", 0.5, lambda: mon.note_span("rollout")),
                           ("env_wait", 0.25, lambda: mon.note_span("env_wait")),
                           ("dispatch", 1.0, lambda: mon.note_dispatch("train_step", "train")),
                           ("train", 2.0, lambda: mon.note_span("train")),
                           ("stall", 9.0, lambda: mon._mark_stalled(9.0, threshold_s=5.0)),
                           ("train", 1.0, lambda: mon.note_span("train")),
                           ("ckpt", 0.5, lambda: mon.note_span("checkpoint")),
                           ("dispatch", 1.0, lambda: mon.note_dispatch("train_step", "train"))]:
        clock[0] += dt
        tele.seconds += dt if name in ("train", "dispatch") else 0.0
        hook()
        gauges.append(mon.interval_metrics())
    mon.close()
    return events, gauges, mon.summary()


def test_goodput_monitor_journals_what_the_jax_one_does():
    got, want = _drive_goodput(GoodputMonitor), _drive_goodput(JaxGoodputMonitor)
    assert [e for e, _ in got[0]] == [e for e, _ in want[0]]
    assert {"state_change", "stall", "stall_end"} <= {e for e, _ in got[0]}
    assert got == want


def test_tiny_config_runs_the_health_stats_by_default():
    cfg = compose([o for o in TINY if o != "diagnostics=off"] + ["env.id=discrete_dummy"])
    agent = build_agent((2,), False, cfg, OBS_SPACE, None, "cpu")
    step = make_train_step(agent, make_optimizers(cfg, agent), cfg, False)
    assert step.health_names[:5] == ["grad_norm", "update_norm", "param_norm", "update_ratio", "dead_frac"]
