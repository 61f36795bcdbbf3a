"""The port's readers of a run against the JAX package's, on the CPU at tiny
widths: ``diagnostics/report.py`` function by function, the six report
tools (``python -m sheeprl_tpu_torch.tools.*_report`` against the repo's
``tools/*_report.py``), the search harness (``tools/search.py``) and the
reward tools (``tools/recover_rewards.py``, ``tools/analyze_rewards.py``).

One port run (DreamerV3 at tiny widths under ``diagnostics=full``, its
replay exported, TensorBoard on) and the serving scenario of
``tests/test_torch_serving_ops.py`` (the port's server with a fake policy:
promotions, a health-gate rejection, the slow-request drill, the request
log) give the journals, traces and dataset both packages read; every
comparison is exact (the wall clock pinned where a line reads it).
"""

from __future__ import annotations

import copy
import csv
import importlib.util
import inspect
import itertools
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import sheeprl_tpu.diagnostics.report as jax_report
from sheeprl_tpu.diagnostics.health import active_anomalies as jax_active_anomalies
from sheeprl_tpu.diagnostics.health import metric_series as jax_metric_series
from sheeprl_tpu.diagnostics.health import watched_metric_names as jax_watched_metric_names
from sheeprl_tpu.diagnostics.journal import read_journal as jax_read_journal
from sheeprl_tpu.tools import analyze_rewards as jax_analyze
from sheeprl_tpu.tools import recover_rewards as jax_recover
from sheeprl_tpu.tools import search as jax_search
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.diagnostics import report
from sheeprl_tpu_torch.serving import server
from sheeprl_tpu_torch.serving.server import ServeApp
from sheeprl_tpu_torch.tools import analyze_rewards, recover_rewards, search
from sheeprl_tpu_torch.utils.checkpoint import save_state
from test_torch_serving_ops import SCENARIO_SERVING, _fake_handle, _run_dir, _scenario, _training_journal
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("journal", "health", "goodput", "memory", "trace", "dataset")
RUN = ["exp=dreamer_v3", "env=dummy", "fabric.accelerator=cpu", "env.capture_video=False", "env.screen_size=16",
       "algo.dense_units=8", "algo.world_model.encoder.cnn_channels_multiplier=2",
       "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.representation_model.hidden_size=8",
       "algo.world_model.transition_model.hidden_size=8", "algo.world_model.discrete_size=4",
       "algo.world_model.stochastic_size=4", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4",
       "algo.horizon=3", "algo.learning_starts=16", "algo.total_steps=32", "buffer.size=64", "env.num_envs=2",
       "diagnostics=full", "diagnostics.telemetry.http.enabled=False", "buffer.checkpoint=True",
       "buffer.export=True", "checkpoint.every=16", "metric.log_every=4", "algo.run_test=False", "run_name=r"]
PPO_TINY = ["env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False",
            "fabric.accelerator=cpu", "metric.logger=null", "algo.rollout_steps=8", "algo.per_rank_batch_size=4",
            "algo.update_epochs=1", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]", "diagnostics=off"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's DreamerV3 run (its run dir, under ``logs/runs/<algo>/<env>``
    of a scratch dir) and its server's log dir after the serving scenario."""
    base = tmp_path_factory.mktemp("reports")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        out = cli.run(RUN)
        serve_root = base / "serve"
        version = _run_dir(serve_root)
        first = version / "checkpoint" / "ckpt_4_0.ckpt"
        _training_journal(version, [{"t": 0.1, "event": "metrics", "step": 4}])
        save_state(str(first), {"agent": {"w": np.ones(1, np.float32)}})
        os.chdir(serve_root)
        cfg = {"run_name": "ops", "env": {"id": "fake"}, "serving": copy.deepcopy(SCENARIO_SERVING),
               "diagnostics": {"serving": {"inject_slow_iter": 1}}}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(server, "load_policy",
                       lambda cfg, path, device: _fake_handle(stateful=True, ckpt_path=path, ckpt_step=4))
            app = ServeApp(cfg, str(first), "cpu")
            _scenario(app, save_state, version)
    finally:
        os.chdir(cwd)
    run_dir = Path(out["log_dir"]).resolve() if os.path.isabs(out["log_dir"]) else (base / out["log_dir"]).resolve()
    return {"base": base, "run_dir": run_dir, "serve_dir": Path(app.log_dir).resolve()
            if os.path.isabs(app.log_dir) else (serve_root / app.log_dir).resolve(), "out": out}


def _events(runs):
    train = jax_read_journal(str(runs["run_dir"] / "journal.jsonl"))
    serve = jax_read_journal(str(runs["serve_dir"] / "journal.jsonl"))
    return train, serve


def test_the_run_and_the_server_journaled_what_the_reports_read(runs):
    train, serve = _events(runs)
    kinds = {e["event"] for e in train} | {e["event"] for e in serve}
    assert {"run_start", "metrics", "checkpoint", "state_change", "ckpt_end", "run_end", "serve_start",
            "ckpt_promote", "ckpt_reject", "slo_breach", "slow_request", "request_log_rotate"} <= kinds
    assert (runs["run_dir"] / "trace.json").exists() and (runs["serve_dir"] / "trace_serve.json").exists()
    assert (runs["run_dir"] / "dataset").is_dir()


# ---------------------------------------------------------------------------
# diagnostics/report.py, function by function
# ---------------------------------------------------------------------------


def _functions(module):
    return {name for name, fn in vars(module).items()
            if inspect.isfunction(fn) and fn.__module__ == module.__name__}


def test_report_has_every_function_of_the_jax_one():
    assert _functions(report) == _functions(jax_report) | {"metric_series", "watched_metric_names",
                                                             "active_anomalies"}


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as err:  # noqa: BLE001 - both packages must fail alike too
        return ("raised", type(err).__name__, str(err))


@pytest.fixture()
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.8e9)


BANNER_ARGS = {
    "no_recent_ckpt_banner": [(None, None), (10.0, None), (10.0, 60.0), (500.0, 60.0), (1e4, 600.0)],
    "stale_params_banner": [(None, None), (1, 4), (4, 4), (9, 4), ("x", 4)],
    "sessions_full_banner": [(None, None), (3, 8), (8, 8), (9, 8)],
    "slo_burn_banner": [("default", None), ("default", 0.5), ("canary", 1.0), ("m", 2.5), ("m", "x")],
    "format_bytes": [(None,), (0,), (1023,), (1024,), (5 * 2**20,), (3.5 * 2**30,), (2**50,), (-1,), ("x",)],
    "_median": [([],), ([1.0],), ([3.0, 1.0, 2.0],), ([1.0, 2.0, 3.0, 4.0],)],
}
EVENT_LISTS = ("status_block", "checkpoint_status_lines", "isolation_status_lines", "goodput_status_lines",
               "health_status_lines", "memory_status_lines", "serving_status_lines", "serving_latency_lines",
               "active_anomalies")
ONE_EVENT = ("format_event_line", "format_memory_breakdown", "format_sharding_audit", "format_fsdp_shard_map")


@pytest.mark.parametrize("journal", ["train", "serve", "both"])
def test_every_report_function_gives_the_jax_text(runs, pinned_clock, tmp_path, journal):
    train, serve = _events(runs)
    events = {"train": train, "serve": serve, "both": train + serve}[journal]
    for name in EVENT_LISTS:
        jax_fn = jax_active_anomalies if name == "active_anomalies" else getattr(jax_report, name)
        kwargs = [{}] if name in ("status_block", "memory_status_lines", "active_anomalies") else \
            [{"live": True}, {"live": False}]
        for kw in kwargs:
            # every prefix: the live panels of a run as it goes
            for n in sorted({1, 2, len(events) // 3, len(events) // 2, len(events)}):
                assert _outcome(getattr(report, name), events[:n], **kw) == _outcome(jax_fn, events[:n], **kw), \
                    (name, kw, n)
    for name in ONE_EVENT:
        for event in events:
            assert _outcome(getattr(report, name), event) == _outcome(getattr(jax_report, name), event), (name, event)
    prefixes = ["Telemetry/health/", "Loss/", "Rewards/rew_avg", "Serving/", "Telemetry/"]
    assert report.watched_metric_names(events, prefixes) == jax_watched_metric_names(events, prefixes)
    for metric in report.watched_metric_names(events, prefixes):
        assert report.metric_series(events, metric) == jax_metric_series(events, metric)
    for name, cases in BANNER_ARGS.items():
        for args in cases:
            assert _outcome(getattr(report, name), *args) == _outcome(getattr(jax_report, name), *args), (name, args)
    metrics = [e.get("metrics") or {} for e in events if e.get("event") == "metrics"]
    for m in metrics:
        assert _outcome(report._phase_summary, m) == _outcome(jax_report._phase_summary, m)
    # the journal files: summary, its text, the CSV export
    d = {"train": runs["run_dir"], "serve": runs["serve_dir"], "both": runs["run_dir"]}[journal]
    summary = report.summarize(str(d))
    assert summary == jax_report.summarize(str(d))
    assert report.format_summary(summary) == jax_report.format_summary(summary)
    assert report.to_csv(str(d), str(tmp_path / "port.csv")) == jax_report.to_csv(str(d), str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


# ---------------------------------------------------------------------------
# the six report tools
# ---------------------------------------------------------------------------


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"root_{name}_report", ROOT / "tools" / f"{name}_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tool_cases(runs, tmp_path):
    run_dir, serve_dir = str(runs["run_dir"]), str(runs["serve_dir"])
    return {
        "journal": [[run_dir], [run_dir, "--json"], [run_dir, "--csv", str(tmp_path / "history.csv")], [serve_dir],
                    [str(tmp_path / "nowhere")]],
        "health": [[run_dir], [run_dir, "--json"], [run_dir, "--watch", "Loss/"], [serve_dir]],
        "goodput": [[run_dir], [run_dir, "--json"], [run_dir, serve_dir]],
        "memory": [[run_dir], [serve_dir]],
        "trace": [[run_dir], [str(runs["run_dir"] / "trace.json")], [str(runs["serve_dir"] / "trace_serve.json")],
                  [run_dir, "--json"], [serve_dir, "--out", str(tmp_path / "merged.json")]],
        "dataset": [[str(runs["run_dir"] / "dataset")], [str(runs["run_dir"] / "dataset"), "--deep"]],
    }


@pytest.mark.parametrize("tool", TOOLS)
def test_each_report_tool_prints_what_the_root_tool_prints(runs, tool, tmp_path, capsys, monkeypatch):
    root = _root_tool(tool)
    port = importlib.import_module(f"sheeprl_tpu_torch.tools.{tool}_report")
    for args in _tool_cases(runs, tmp_path)[tool]:
        monkeypatch.setattr(sys, "argv", [f"{tool}_report.py", *args])
        want_rc = root.main()
        want = capsys.readouterr()
        written = {p: p.read_text() for p in tmp_path.iterdir() if p.is_file()}
        got_rc = port.main(args)
        got = capsys.readouterr()
        assert (got_rc, got.out, got.err) == (want_rc, want.out, want.err), args
        assert {p: p.read_text() for p in tmp_path.iterdir() if p.is_file()} == written
    assert want.out or want.err


# ---------------------------------------------------------------------------
# the search harness
# ---------------------------------------------------------------------------

SPACE = {"algo.x": [0.0, 0.2, 0.4, 0.6, 0.8, 1.0], "algo.y": [0.0, 0.25, 0.5, 0.75, 1.0]}


def _args(module, tmp_path, sampler, scheduler, n_trials=30, seed0=0):
    return module.parse_args(["--exp=ppo", "--full-steps=81", "--fidelity-frac=1.0", f"--n-trials={n_trials}",
                              "--rungs=3", "--reduction-factor=3", f"--sampler={sampler}", f"--scheduler={scheduler}",
                              f"--seed0={seed0}", "--tpe-startup=8",
                              f"--output-dir={tmp_path / module.__name__ / (sampler + '_' + scheduler)}",
                              "--space", json.dumps(SPACE)])


def _objective(params, steps, seed, trial_id, rung):
    """The JAX tests' synthetic objective: peaked at x=0.6, y=0.75, blurred
    at low budgets; the configurations at y=0 fail, to score ``-inf``."""
    if params["algo.y"] == 0.0:
        return float("-inf")
    quality = -((params["algo.x"] - 0.6) ** 2) - ((params["algo.y"] - 0.75) ** 2)
    return quality * (1.0 + 10.0 / steps)


@pytest.mark.parametrize("sampler", ["random", "grid"])
@pytest.mark.parametrize("n_trials,seed", [(4, 0), (30, 3), (40, 7)])
def test_sample_trials_draws_the_jax_trials(sampler, n_trials, seed):
    assert search.sample_trials(SPACE, n_trials, sampler, seed) == jax_search.sample_trials(SPACE, n_trials, sampler,
                                                                                             seed)


def test_the_tpe_sampler_proposes_the_jax_sequence():
    port, ref = search.TPESampler(SPACE, seed=1, n_startup=6), jax_search.TPESampler(SPACE, seed=1, n_startup=6)
    for _ in range(40):
        p, r = port.ask(), ref.ask()
        assert p == r
        value = _objective(p, 27, 0, 0, 0)
        port.tell(p, value)
        ref.tell(r, value)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "wall_time_s"} for r in records]


@pytest.mark.parametrize("sampler,scheduler", list(itertools.product(["random", "grid", "tpe"], ["asha", "halving"])))
def test_the_schedulers_give_the_jax_records(tmp_path, sampler, scheduler, capsys):
    runner = {"asha": "asha", "halving": "successive_halving"}[scheduler]
    out = {}
    for module in (search, jax_search):
        args = _args(module, tmp_path, sampler, scheduler)
        records = getattr(module, runner)(args, _objective)
        module.save_study(records, args)
        out[module] = (records, Path(args.output_dir))
    (got, got_dir), (want, want_dir) = out[search], out[jax_search]
    assert _strip(got) == _strip(want) and any(not math.isfinite(r["eval_return"]) for r in got)
    for name in ("topk.json", "best_config.yaml", "SUMMARY.md"):
        assert (got_dir / name).read_text() == (want_dir / name).read_text()
    with open(got_dir / "results.csv") as a, open(want_dir / "results.csv") as b:
        assert _strip(csv.DictReader(a)) == _strip(csv.DictReader(b))


def test_a_two_trial_search_over_the_ports_ppo_completes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "study"
    search.main(["--exp=ppo", "--full-steps=32", "--fidelity-frac=1.0", "--n-trials=2", "--rungs=1",
                 "--sampler=grid", f"--output-dir={out}", "--space", json.dumps({"algo.ent_coef": [0.0, 0.01]}),
                 *[f"--override={o}" for o in PPO_TINY]])
    with open(out / "results.csv") as fp:
        rows = list(csv.DictReader(fp))
    assert len(rows) == 2 and all(r["state"] == "COMPLETE" for r in rows), rows
    assert not list(out.rglob("error.txt"))
    topk = json.loads((out / "topk.json").read_text())
    assert len(topk) == 2 and topk[0]["best_eval_return"] >= topk[1]["best_eval_return"]
    assert (out / "best_config.yaml").exists() and "Best command" in (out / "SUMMARY.md").read_text()


def test_a_failed_trial_scores_minus_inf_and_leaves_its_error(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    value = search.run_trial("ppo", {"algo.ent_coef": 0.0}, 16, 0, tmp_path / "trial",
                             extra_overrides=[*PPO_TINY, "algo.rollout_steps=-1"])
    assert value == float("-inf") and (tmp_path / "trial" / "error.txt").read_text()


# ---------------------------------------------------------------------------
# the reward tools
# ---------------------------------------------------------------------------


def test_recover_and_analyze_give_the_jax_rows_and_stats(runs, tmp_path, capsys):
    logs = runs["base"] / "logs" / "runs"
    assert recover_rewards.list_runs(str(logs)) == jax_recover.list_runs(str(logs))
    run_path = recover_rewards.list_runs(str(logs))[0]["path"]
    # a crashed run's memmap survivors, as the JAX test simulates them
    survivors = Path(run_path) / "version_0" / "memmap_buffer" / "rank_0" / "env_0"
    survivors.mkdir(parents=True, exist_ok=True)
    np.linspace(-1, 1, 16, dtype=np.float32).tofile(survivors / "rewards.memmap")
    assert "memmap" in recover_rewards.list_runs(str(logs))[0]["formats"]
    for fmt in ("all", "tensorboard", "memmap"):
        got, want = recover_rewards.recover(run_path, fmt), jax_recover.recover(run_path, fmt)
        assert got == want and got
    recovered = recover_rewards.recover(run_path, "all")
    assert set(recovered) == {"tensorboard", "memmap"}
    written = recover_rewards.save_csv(recovered, str(tmp_path / "port"))
    jax_written = jax_recover.save_csv(recovered, str(tmp_path / "jax"))
    capsys.readouterr()
    for mine, theirs in zip(written, jax_written):
        assert Path(mine).read_text() == Path(theirs).read_text()
        stats = analyze_rewards.analyze(mine)
        printed = capsys.readouterr().out
        assert stats == jax_analyze.analyze(theirs)
        assert printed.replace(mine, theirs) == capsys.readouterr().out
    recover_rewards.main(["--logs-dir", str(logs), "--list-runs"])
    printed = capsys.readouterr().out
    jax_recover.main(["--logs-dir", str(logs), "--list-runs"])
    assert printed == capsys.readouterr().out and run_path in printed
