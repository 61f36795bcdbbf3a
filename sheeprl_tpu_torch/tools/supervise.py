"""Auto-restart supervisor for training runs (counterpart of the repo's
``tools/supervise.py``; a launcher over
``sheeprl_tpu_torch.resilience.supervisor``, same flags):

    python -m sheeprl_tpu_torch.tools.supervise --max-restarts 5 -- \\
        exp=dreamer_v3 env=dummy run_name=prod_run checkpoint.every=5000

It restarts the run on any exit other than 0 with capped exponential
backoff (a graceful preemption, exit 75, respawns at once), resumes from the
newest checkpoint whose manifest verifies, and journals ``restart`` events
to ``<run dir>/supervisor.jsonl``, which
``python -m sheeprl_tpu_torch.tools.goodput_report`` reads for the time to
recover.
"""

import sys

from sheeprl_tpu_torch.resilience.supervisor import main

if __name__ == "__main__":
    main(sys.argv[1:])
