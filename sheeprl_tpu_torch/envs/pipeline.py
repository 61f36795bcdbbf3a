"""Split-phase (``step_async`` / ``step_wait``) vector envs (counterpart of
``sheeprl_tpu/envs/pipeline.py``).

The loops issue the env step as soon as the actions are on the host, keep
the device busy (the gradient steps, the replay write) while the envs step,
and block in ``step_wait`` only where they need the observations.

Every executor is split-phase itself, with the JAX ``PipelinedVectorEnv``'s
misuse errors (``executor.VectorEnv``), so ``env.py``'s
``pipelined_vector_env`` returns the executor as it is; the JAX name stays
as an alias.  Executors (``env.executor``; ``null``/``auto`` follows
``env.sync_env``):

* ``sync`` — ``env.py``'s ``SyncVectorEnv``; ``step_async`` runs the serial
  step on one background thread;
* ``async`` — ``executor.AsyncVectorEnv``, one spawned process per env;
* ``shared_memory`` — ``executor.SharedMemoryVectorEnv``, persistent slab
  workers over shared buffers (``env.envs_per_worker``).

All three keep ``SAME_STEP`` autoreset, and ``step()`` is
``step_async`` + ``step_wait``.
"""

from __future__ import annotations

from sheeprl_tpu_torch.envs.executor import VectorEnv

EXECUTORS = ("sync", "async", "shared_memory")

PipelinedVectorEnv = VectorEnv
