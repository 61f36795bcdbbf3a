"""``python -m sheeprl_tpu_torch run exp=... | eval checkpoint_path=... | serve checkpoint_path=... |
registration checkpoint_path=... | export <run dir>``."""

import sys

USAGE = (
    "usage: python -m sheeprl_tpu_torch run exp=dreamer_v3|ppo env=dummy [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch run exp=dreamer_v3|ppo env=dummy "
    "checkpoint.resume_from=<run dir or checkpoint> [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch run exp=dreamer_v3|sac|droq algo.offline.enabled=true "
    "algo.offline.dataset_dir=<dataset> [dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch eval checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch serve checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch registration checkpoint_path=<run>/checkpoint/ckpt_<step>_<rank>.ckpt "
    "[dotted.key=value ...]\n"
    "       python -m sheeprl_tpu_torch export <run dir> [--out <dataset dir>] [--shard-rows N]"
)

if __name__ == "__main__":
    # imported here, not at the top: the env workers that the executors
    # spawn import this module again, and need no torch
    if len(sys.argv) > 1 and sys.argv[1] == "export":
        from sheeprl_tpu_torch.offline.export import main as export_main

        sys.exit(export_main(sys.argv[2:]))
    from sheeprl_tpu_torch.cli import evaluation, registration, run, serve

    commands = {"run": run, "eval": evaluation, "serve": serve, "registration": registration}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        sys.exit(USAGE)
    result = commands[sys.argv[1]](sys.argv[2:])
    if sys.argv[1] == "eval":
        print(f"Test/cumulative_reward: {result}")
