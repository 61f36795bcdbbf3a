"""Chaos drill: run a scripted fault schedule through the port's CLI and
check the recovery invariants (counterpart of the repo's
``tools/chaos_drill.py``; a launcher over
``sheeprl_tpu_torch.resilience.chaos``, same flags):

    python -m sheeprl_tpu_torch.tools.chaos_drill --drill preempt --iter 3 -- exp=dreamer_v3 env=dummy ...
    python -m sheeprl_tpu_torch.tools.chaos_drill \\
        --schedule '[{iter: 2, fault: slow_write}, {iter: 4, fault: preempt}]' -- <run overrides>
    python -m sheeprl_tpu_torch.tools.chaos_drill --drill trainer_exception

Faults: ``nan_grads``, ``trainer_exception``, ``slow_write``, ``preempt``.
Without overrides after ``--`` the workload is the JAX package's default, a
decoupled PPO run of one player and one trainer, on the card (the CPU with
``-- <that list> fabric.accelerator=cpu``).  Exit 0: every invariant held.
"""

import sys

from sheeprl_tpu_torch.resilience.chaos import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
