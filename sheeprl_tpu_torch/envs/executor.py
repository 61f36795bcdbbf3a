"""The vector envs (counterpart of ``sheeprl_tpu/envs/executor.py`` and of
the gymnasium vector envs the JAX package builds), without gymnasium.

* :class:`VectorEnv` — what every executor shares: split-phase
  ``step_async`` / ``step_wait`` with the JAX ``PipelinedVectorEnv``'s
  misuse errors, the spaces, the batched action shape, random actions for
  the prefill and gymnasium's ``_add_info``, so the infos of every
  executor have gymnasium's layout.
* :class:`AsyncVectorEnv` — one spawned process per env, stepped through a
  pipe each, with native ``step_async`` / ``step_wait`` (gymnasium's
  ``AsyncVectorEnv``).
* :class:`SharedMemoryVectorEnv` — persistent slab workers over shared
  buffers (the EnvPool model): actions are written in place by the parent,
  observations, rewards and flags by the workers; the per-step traffic is
  one command byte down and one ack back per worker, plus a pickle only for
  the envs whose info is not empty.  ``envs_per_worker`` sets the slab
  size (:func:`auto_envs_per_worker` by default).

Autoreset is gymnasium's ``SAME_STEP`` in all of them, bit for bit with the
JAX package's executor of the same name: when an env's episode ends, the
observation returned is the new episode's first, the last one rides in
``infos["final_obs"]`` (an object array, ``None`` where no episode ended)
and that step's info in ``infos["final_info"]``, each key with its ``_key``
mask.  Rewards are float64 in the synchronous and async executors, float32
in the shared-memory one, as in the JAX package.

Workers start with the ``spawn`` context and import only this module and
what the env thunks need (numpy and the port's env modules): nothing there
imports torch or touches CUDA.  The env thunks cross by the standard
pickle, so they must be module-level objects (``env.py``'s ``EnvThunk``).
Every executor closes its workers in ``close`` and, failing that, when the
interpreter exits (a finalizer), whatever the exit path.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces

_CMD_STEP = b"S"  # step every env of the worker's slab
_CMD_CLOSE = b"C"
_CMD_RESET = b"R"  # followed by pickled (per-slab seed list, options)
_ACK_EMPTY = b"n"  # slab stepped: every info was {} and no episode ended


class VectorEnv:
    """The part every executor shares: the split-phase step and its misuse
    errors (the JAX package's ``PipelinedVectorEnv``), the spaces, the
    batched action shape, random actions and the infos layout.  Subclasses
    set ``num_envs``, ``single_observation_space`` and
    ``single_action_space`` and implement ``_reset``, ``_step_async``,
    ``_step_wait`` and ``_close``."""

    num_envs: int
    single_observation_space: Any
    single_action_space: Any
    _pending = False

    def reset(self, *, seed=None, options=None):
        if self._pending:
            raise RuntimeError("reset() called while a step_async is in flight")
        return self._reset(_seeds(seed, self.num_envs), options)

    def step_async(self, actions: Any) -> None:
        """Start stepping the envs; returns at once."""
        if self._pending:
            raise RuntimeError("step_async() called while a previous step is still in flight")
        self._step_async(actions)
        # only after a dispatch that did not raise: a bad action must leave
        # the env usable, not stuck in flight
        self._pending = True

    def step_wait(self):
        """Block until the step in flight ends; the usual 5-tuple."""
        if not self._pending:
            raise RuntimeError("step_wait() called with no step_async in flight")
        self._pending = False
        return self._step_wait()

    def step(self, actions: Any):
        self.step_async(actions)
        return self.step_wait()

    def close(self, **kwargs) -> None:
        if self._pending:  # drain so every env stops at a step boundary
            try:
                self.step_wait()
            except Exception:  # noqa: BLE001 - already tearing down
                pass
        self._close()

    @property
    def batched_action_shape(self) -> Tuple[int, ...]:
        return (self.num_envs,) + tuple(self.single_action_space.shape)

    def sample_actions(self, rng: np.random.Generator) -> np.ndarray:
        """Uniform random actions for every env (the prefill's)."""
        space, n = self.single_action_space, self.num_envs
        if isinstance(space, spaces.Discrete):
            return rng.integers(0, space.n, size=(n,))
        if isinstance(space, spaces.MultiDiscrete):
            return rng.integers(0, space.nvec, size=(n,) + space.nvec.shape)
        if isinstance(space, spaces.Box):
            # uniform where both bounds are finite, a standard normal elsewhere
            shape = (n,) + space.shape
            bounded = np.isfinite(space.low) & np.isfinite(space.high)
            low, high = np.where(bounded, space.low, 0.0), np.where(bounded, space.high, 0.0)
            uniform = low + (high - low) * rng.random(shape)
            return np.where(bounded, uniform, rng.standard_normal(shape)).astype(space.dtype)
        raise NotImplementedError(f"sampling {space!r} is not ported")

    def _stack(self, obs: Sequence[Any]) -> Any:
        """The per-env observations batched in the space's dtypes."""
        space = self.single_observation_space
        if isinstance(space, spaces.Dict):
            return {k: np.stack([np.asarray(o[k]) for o in obs]).astype(space[k].dtype, copy=False)
                    for k in space.keys()}
        return np.stack([np.asarray(o) for o in obs]).astype(space.dtype, copy=False)

    def _add_info(self, vector_infos: Dict[str, Any], env_info: Dict[str, Any], env_num: int) -> Dict[str, Any]:
        """gymnasium's ``VectorEnv._add_info``: each key of one env's info
        into an array over the envs, with a ``_key`` mask of the envs that
        reported it; dicts recursively, ``final_obs`` as an object array."""
        for key, value in env_info.items():
            if key == "final_obs":
                array = vector_infos["final_obs"] if "final_obs" in vector_infos else np.full(
                    self.num_envs, fill_value=None, dtype=object)
                array[env_num] = value
            elif isinstance(value, dict):
                array = self._add_info(vector_infos.get(key, {}), value, env_num)
            else:
                if key not in vector_infos:
                    if type(value) in [int, float, bool] or issubclass(type(value), np.number):
                        array = np.zeros(self.num_envs, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((self.num_envs, *value.shape), dtype=value.dtype)
                    else:
                        array = np.full(self.num_envs, fill_value=None, dtype=object)
                else:
                    array = vector_infos[key]
                array[env_num] = value
            array_mask = vector_infos.get(f"_{key}", np.zeros(self.num_envs, dtype=np.bool_))
            array_mask[env_num] = True
            vector_infos[key], vector_infos[f"_{key}"] = array, array_mask
        return vector_infos

    def _probe(self, env_fn: Callable[[], Any]) -> None:
        """The spaces and metadata, from one env built and closed here."""
        probe = env_fn()
        try:
            self.metadata = dict(getattr(probe, "metadata", {}) or {})
            self.single_observation_space = probe.observation_space
            self.single_action_space = probe.action_space
        finally:
            probe.close()


def _seeds(seed: Any, num_envs: int) -> List[Optional[int]]:
    if seed is None:
        return [None] * num_envs
    if isinstance(seed, int):
        return [seed + i for i in range(num_envs)]
    seeds = list(seed)
    if len(seeds) != num_envs:
        raise ValueError(f"expected {num_envs} seeds, got {len(seeds)}")
    return seeds


def _shutdown(pipes: List[Any], processes: List[Any], close_msg: Any) -> None:
    """Tell every worker to close, wait briefly, terminate the stragglers."""
    for pipe in pipes:
        try:
            close_msg(pipe)
        except (BrokenPipeError, OSError, EOFError):
            pass
    deadline = time.monotonic() + 5.0
    for proc in processes:
        proc.join(max(0.1, deadline - time.monotonic()))
        if proc.is_alive():
            proc.terminate()
            proc.join(1.0)
    for pipe in pipes:
        try:
            pipe.close()
        except OSError:
            pass


# -- one process per env ---------------------------------------------------
def _async_worker(env_fn: Callable[[], Any], pipe) -> None:
    """gymnasium's async worker under ``SAME_STEP``: one env, one command
    at a time, each answered ``(result, ok)``."""
    env = env_fn()
    try:
        while True:
            command, data = pipe.recv()
            try:
                if command == "reset":
                    pipe.send((env.reset(**data), True))
                elif command == "step":
                    observation, reward, terminated, truncated, info = env.step(data)
                    if terminated or truncated:
                        reset_observation, reset_info = env.reset()
                        info = {"final_info": info, "final_obs": observation, **reset_info}
                        observation = reset_observation
                    pipe.send(((observation, reward, terminated, truncated, info), True))
                elif command == "close":
                    pipe.send((None, True))
                    break
                else:
                    raise RuntimeError(f"unknown command {command!r}")
            except Exception as err:  # noqa: BLE001 - surfaced in the parent
                pipe.send((f"{err!r}\n{traceback.format_exc()}", False))
    finally:
        try:
            env.close()
        finally:
            pipe.close()


class AsyncVectorEnv(VectorEnv):
    """One spawned process per env, each stepped through its pipe."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        env_fns = list(env_fns)
        if not env_fns:
            raise ValueError("AsyncVectorEnv needs at least one env fn")
        self.num_envs = len(env_fns)
        self._probe(env_fns[0])
        ctx = mp.get_context("spawn")
        self._pipes, self._processes = [], []
        for i, fn in enumerate(env_fns):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_async_worker, name=f"async-env-{i}", args=(fn, child), daemon=True)
            proc.start()
            child.close()
            self._pipes.append(parent)
            self._processes.append(proc)
        self._finalizer = weakref.finalize(self, _shutdown, self._pipes, self._processes,
                                           lambda pipe: pipe.send(("close", None)))

    def _gather(self) -> List[Any]:
        results, errors = [], []
        for i, pipe in enumerate(self._pipes):
            try:
                result, ok = pipe.recv()
            except (EOFError, ConnectionResetError) as err:
                raise RuntimeError(f"env worker {i} died") from err
            results.append(result)
            if not ok:
                errors.append(f"env worker {i} raised:\n{result}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results

    def _reset(self, seeds, options):
        for pipe, s in zip(self._pipes, seeds):
            pipe.send(("reset", {"seed": s, "options": options}))
        infos: Dict[str, Any] = {}
        obs = []
        for i, (o, info) in enumerate(self._gather()):
            obs.append(o)
            infos = self._add_info(infos, info, i)
        return self._stack(obs), infos

    def _step_async(self, actions) -> None:
        for pipe, action in zip(self._pipes, np.asarray(actions)):
            pipe.send(("step", action))

    def _step_wait(self):
        obs, rewards, terminations, truncations, infos = [], [], [], [], {}
        for i, (o, r, term, trunc, info) in enumerate(self._gather()):
            obs.append(o)
            rewards.append(r)
            terminations.append(term)
            truncations.append(trunc)
            infos = self._add_info(infos, info, i)
        return (self._stack(obs), np.array(rewards, dtype=np.float64), np.array(terminations, dtype=np.bool_),
                np.array(truncations, dtype=np.bool_), infos)

    def _close(self) -> None:
        self._finalizer()


# -- persistent slab workers over shared memory ------------------------------
def _obs_layout(space: Any) -> List[Tuple[Optional[str], tuple, np.dtype]]:
    """A Dict-of-Box (or a Box) observation space as ``(key, shape, dtype)``
    buffer specs; ``key is None`` for a bare Box."""
    if isinstance(space, spaces.Dict):
        return [(k, tuple(s.shape), np.dtype(s.dtype)) for k, s in space.spaces.items()]
    if isinstance(space, spaces.Box):
        return [(None, tuple(space.shape), np.dtype(space.dtype))]
    raise TypeError(f"SharedMemoryVectorEnv supports Box or Dict[str, Box] observation spaces, got: {space}")


def _alloc(ctx, num_envs: int, layout) -> Dict[Optional[str], Any]:
    """One shared byte buffer per obs key, sized ``[num_envs, *shape]``."""
    return {key: ctx.RawArray("b", int(num_envs * np.prod(shape, dtype=np.int64) * dtype.itemsize) or 1)
            for key, shape, dtype in layout}


def _views(bufs, num_envs: int, layout) -> Dict[Optional[str], np.ndarray]:
    return {key: np.frombuffer(bufs[key], dtype=dtype)[: num_envs * int(np.prod(shape, dtype=np.int64))].reshape(
        num_envs, *shape) for key, shape, dtype in layout}


def _write_obs(views: Dict[Optional[str], np.ndarray], index: int, obs: Any) -> None:
    for key, view in views.items():
        view[index] = obs if key is None else np.asarray(obs[key])


def _read_obs(views: Dict[Optional[str], np.ndarray], index: int) -> Any:
    if list(views.keys()) == [None]:
        return np.array(views[None][index], copy=True)
    return {k: np.array(v[index], copy=True) for k, v in views.items()}


def auto_envs_per_worker(num_envs: int) -> int:
    """The default slab size: one env per worker up to one worker per host
    core, then larger slabs instead of more processes."""
    workers = max(1, min(int(num_envs), os.cpu_count() or 1))
    return -(-int(num_envs) // workers)


def _shm_worker(start: int, env_fns, pipe, obs_bufs, final_bufs, act_buf, rew_buf, term_buf, trunc_buf, obs_specs,
                act_shape, act_dtype, num_envs: int) -> None:
    """A slab worker: owns envs ``[start, start + len(env_fns))`` and steps
    or resets them in place over the shared buffers, one command and one ack
    per vector step.  A ``RestartOnException`` around the env thunks absorbs
    an env's crash here, and its info flag still reaches the parent."""
    envs = [fn() for fn in env_fns]
    obs_views = _views(obs_bufs, num_envs, obs_specs)
    final_views = _views(final_bufs, num_envs, obs_specs)
    act_view = np.frombuffer(act_buf, dtype=act_dtype)[: int(np.prod(act_shape, dtype=np.int64))].reshape(act_shape)
    rew_view = np.frombuffer(rew_buf, dtype=np.float32)
    term_view = np.frombuffer(term_buf, dtype=np.uint8)
    trunc_view = np.frombuffer(trunc_buf, dtype=np.uint8)
    try:
        while True:
            cmd = pipe.recv_bytes()
            try:
                if cmd == _CMD_STEP:
                    # (env index, info, has_final, final_info) for the envs
                    # with something to pickle; a quiet slab acks one byte
                    payloads: List[Tuple[int, dict, bool, Optional[dict]]] = []
                    for offset, env in enumerate(envs):
                        index = start + offset
                        action = act_view[index]
                        if action.ndim > 0:
                            action = np.array(action, copy=True)  # off the shared page
                        obs, reward, terminated, truncated, info = env.step(action)
                        has_final, final_info = False, None
                        if terminated or truncated:
                            _write_obs(final_views, index, obs)
                            final_info, has_final = info, True
                            obs, info = env.reset()
                        _write_obs(obs_views, index, obs)
                        rew_view[index] = np.float32(reward)
                        term_view[index] = np.uint8(terminated)
                        trunc_view[index] = np.uint8(truncated)
                        if info or has_final:
                            payloads.append((index, info, has_final, final_info))
                    pipe.send_bytes(pickle.dumps(("ok", payloads)) if payloads else _ACK_EMPTY)
                elif cmd == _CMD_CLOSE:
                    break
                else:  # _CMD_RESET + pickled (slab seed list, options)
                    seeds, options = pickle.loads(cmd[1:])
                    infos: List[dict] = []
                    for offset, env in enumerate(envs):
                        obs, info = env.reset(seed=seeds[offset], options=options)
                        _write_obs(obs_views, start + offset, obs)
                        infos.append(info)
                    pipe.send_bytes(pickle.dumps(("ok", infos)))
            except Exception as err:  # noqa: BLE001 - surfaced in the parent
                pipe.send_bytes(pickle.dumps(("error", f"{err!r}\n{traceback.format_exc()}")))
    finally:
        for env in envs:
            try:
                env.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        pipe.close()


class SharedMemoryVectorEnv(VectorEnv):
    """Persistent slab workers with in-place shared-memory transport and
    native ``step_async`` / ``step_wait``."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]], envs_per_worker: Optional[int] = None):
        self.env_fns = list(env_fns)
        self.num_envs = len(self.env_fns)
        if self.num_envs == 0:
            raise ValueError("SharedMemoryVectorEnv needs at least one env fn")
        if envs_per_worker in (None, "auto"):
            envs_per_worker = auto_envs_per_worker(self.num_envs)
        self.envs_per_worker = int(envs_per_worker)
        if self.envs_per_worker < 1:
            raise ValueError(f"envs_per_worker must be >= 1, got: {envs_per_worker}")
        self._slabs: List[Tuple[int, int]] = [
            (lo, min(lo + self.envs_per_worker, self.num_envs)) for lo in range(0, self.num_envs, self.envs_per_worker)
        ]
        self.num_workers = len(self._slabs)
        self._probe(self.env_fns[0])
        action_space = self.single_action_space
        if not isinstance(action_space, (spaces.Box, spaces.Discrete, spaces.MultiDiscrete)):
            raise TypeError(f"SharedMemoryVectorEnv supports Box, Discrete or MultiDiscrete action spaces, got: "
                            f"{action_space}")

        ctx = mp.get_context("spawn")
        self._obs_specs = _obs_layout(self.single_observation_space)
        self._obs_bufs = _alloc(ctx, self.num_envs, self._obs_specs)
        self._final_bufs = _alloc(ctx, self.num_envs, self._obs_specs)
        act_dtype = np.dtype(action_space.dtype)
        act_shape = self.batched_action_shape
        self._act_buf = ctx.RawArray("b", int(np.prod(act_shape, dtype=np.int64) * act_dtype.itemsize) or 1)
        self._rew_buf = ctx.RawArray("b", self.num_envs * 4)  # float32 end to end
        self._term_buf = ctx.RawArray("b", self.num_envs)
        self._trunc_buf = ctx.RawArray("b", self.num_envs)

        self._obs_views = _views(self._obs_bufs, self.num_envs, self._obs_specs)
        self._final_views = _views(self._final_bufs, self.num_envs, self._obs_specs)
        self._act_view = np.frombuffer(self._act_buf, dtype=act_dtype)[: int(np.prod(act_shape))].reshape(act_shape)
        self._rew_view = np.frombuffer(self._rew_buf, dtype=np.float32)
        self._term_view = np.frombuffer(self._term_buf, dtype=np.uint8)
        self._trunc_view = np.frombuffer(self._trunc_buf, dtype=np.uint8)

        self._pipes, self._processes = [], []
        for lo, hi in self._slabs:
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_shm_worker, name=f"shm-env-{lo}-{hi - 1}",
                args=(lo, tuple(self.env_fns[lo:hi]), child, self._obs_bufs, self._final_bufs, self._act_buf,
                      self._rew_buf, self._term_buf, self._trunc_buf, self._obs_specs, act_shape, act_dtype,
                      self.num_envs),
                daemon=True,
            )
            proc.start()
            child.close()
            self._pipes.append(parent)
            self._processes.append(proc)
        self._finalizer = weakref.finalize(self, _shutdown, self._pipes, self._processes,
                                           lambda pipe: pipe.send_bytes(_CMD_CLOSE))

    def _recv(self, worker: int):
        """One worker's ack: the step payloads or the reset infos; a worker
        error raises."""
        pipe = self._pipes[worker]
        lo, hi = self._slabs[worker]
        try:
            msg = pipe.recv_bytes()
        except (EOFError, ConnectionResetError) as err:
            raise RuntimeError(f"env worker {worker} (envs {lo}..{hi - 1}) died (crashed outside "
                               "RestartOnException?)") from err
        if msg == _ACK_EMPTY:
            return []
        payload = pickle.loads(msg)
        if payload[0] == "error":
            raise RuntimeError(f"env worker {worker} (envs {lo}..{hi - 1}) raised:\n{payload[1]}")
        return payload[1]

    def _batched_obs(self):
        # one copy per key out of the shared slabs: the loops keep the obs
        # across the next step_async, while the workers overwrite the pages
        if list(self._obs_views.keys()) == [None]:
            return np.array(self._obs_views[None], copy=True)
        return {k: np.array(v, copy=True) for k, v in self._obs_views.items()}

    def _reset(self, seeds, options):
        for pipe, (lo, hi) in zip(self._pipes, self._slabs):
            pipe.send_bytes(_CMD_RESET + pickle.dumps((seeds[lo:hi], options)))
        infos: Dict[str, Any] = {}
        for w, (lo, _) in enumerate(self._slabs):
            for offset, info in enumerate(self._recv(w)):
                infos = self._add_info(infos, info, lo + offset)
        return self._batched_obs(), infos

    def _step_async(self, actions) -> None:
        np.copyto(self._act_view, np.asarray(actions, dtype=self._act_view.dtype).reshape(self._act_view.shape))
        for pipe in self._pipes:
            pipe.send_bytes(_CMD_STEP)

    def _step_wait(self):
        infos: Dict[str, Any] = {}
        for w in range(self.num_workers):
            for index, info, has_final, final_info in self._recv(w):
                if has_final:
                    infos = self._add_info(
                        infos, {"final_obs": _read_obs(self._final_views, index), "final_info": final_info or {}},
                        index)
                infos = self._add_info(infos, info, index)
        return (self._batched_obs(), self._rew_view.copy(), self._term_view.astype(np.bool_),
                self._trunc_view.astype(np.bool_), infos)

    def _close(self) -> None:
        self._finalizer()
