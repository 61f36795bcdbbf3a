"""The port's tools (counterpart of ``sheeprl_tpu/tools/`` and of the
repo's run readers under ``tools/``), each runnable as ``python -m
sheeprl_tpu_torch.tools.<name>``: the readers of a run's journal, trace and
dataset (``journal_report``, ``health_report``, ``goodput_report``,
``memory_report``, ``trace_report``, ``dataset_report``), which import no
torch; the hyperparameter search (``search``), whose trials run in process
through ``sheeprl_tpu_torch.cli.run``; the reward-log recovery and its
statistics (``recover_rewards``, ``analyze_rewards``); the live dashboard
and the cross-run diff (``run_monitor``, ``health_diff``), which import no
torch either; the chaos drill and the auto-restart supervisor
(``chaos_drill``, ``supervise``), whose children run ``python -m
sheeprl_tpu_torch run``; and the lint (``sheeprl_lint``, its passes in
``lint/``), static over the port's sources: no torch, no jax, no device."""
