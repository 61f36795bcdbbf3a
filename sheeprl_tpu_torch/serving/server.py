"""The policy server: batched inference behind a stdlib HTTP tier
(counterpart of ``sheeprl_tpu/serving/server.py``).

* :class:`PolicyService` — owns one model's modules, one eager step per
  ``(bucket, greedy)`` signature and the dispatch the batcher drives:
  assemble the padded batch, move it to the device, run the step, slice the
  valid rows; for a stateful policy (DreamerV3) the step gathers the
  sessions' state from the device slab and scatters it back, a stateless
  one (PPO) refuses sessions.
* :class:`ServeApp` — ``ThreadingHTTPServer`` serving ``POST /act`` and
  ``GET /healthz`` with the JAX server's wire format, so one client talks to
  either server.

Randomness comes from ``torch.Generator``s on the device.  A greedy dispatch
re-seeds its generator to 0, the counterpart of the JAX server's
``jax.random.PRNGKey(0)``: the same semantics (the posterior is still
sampled, from a fixed stream), not the same bits.  A stochastic dispatch
draws from a second generator seeded from the clock once.

Left for later (ROADMAP.md Queue 1, item 'Serving extras'): the checkpoint
watcher and its health gate, the SLO monitor and phase histograms,
``/metrics``, the multi-model registry, the request log, the phase trace and
CUDA-graph capture per bucket.  :func:`refuse_unported` raises on a
``serving.models`` or ``serving.request_log.enabled`` the port would ignore,
and :func:`unported_defaults` names the JAX server's defaults that are off
here, which ``ServeApp`` prints at start.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.serving.batcher import DEFAULT_BUCKETS, DynamicBatcher, ServeError, pick_bucket
from sheeprl_tpu_torch.serving.loader import PolicyHandle, load_policy
from sheeprl_tpu_torch.serving.sessions import SessionStore, make_slab_step


def refuse_unported(serving_cfg: Mapping[str, Any]) -> None:
    """Raise on a serving option the port reads and would not act on."""
    if serving_cfg.get("models"):
        raise NotImplementedError(f"serving.models={dict(serving_cfg['models'])!r}: the multi-model registry is not "
                                  "ported yet (see ROADMAP.md Queue 1, item 'Serving extras')")
    if (serving_cfg.get("request_log") or {}).get("enabled", False):
        raise NotImplementedError("serving.request_log.enabled=True: the request log is not ported yet (see "
                                  "ROADMAP.md Queue 1, item 'Serving extras')")


def unported_defaults(serving_cfg: Mapping[str, Any]) -> List[str]:
    """The options of ``serving_cfg`` that the JAX server would act on and
    this one does not run (they are on by default there)."""
    off = []
    if (serving_cfg.get("reload") or {}).get("enabled", True):
        off.append("serving.reload.enabled (checkpoint watcher and hot reload)")
    if (serving_cfg.get("trace") or {}).get("enabled", True):
        off.append("serving.trace.enabled (phase trace)")
    if serving_cfg.get("slo") is not None:
        off.append("serving.slo.* (SLO monitor and phase histograms)")
    return off


class PolicyService:
    """Batched inference over one policy.  Stateful handles get a
    :class:`SessionStore`: each step gathers the batch's session rows from
    the device slab and scatters the new state back in place; stateless
    ones run the handle's ``make_step`` on the padded batch."""

    def __init__(self, handle: PolicyHandle, serving_cfg: Optional[Mapping[str, Any]] = None):
        cfg = dict(serving_cfg or {})
        self.handle = handle
        self.device = handle.device
        self.default_greedy = bool(cfg.get("greedy", True))
        self.buckets = tuple(sorted(int(b) for b in (cfg.get("batch_buckets") or list(DEFAULT_BUCKETS))))
        self.batcher = DynamicBatcher(
            self._dispatch,
            buckets=self.buckets,
            max_delay_ms=float(cfg.get("max_delay_ms", 5.0)),
            max_queue=int(cfg.get("max_queue", 4096)),
        )
        sessions_cfg = dict(cfg.get("sessions") or {})
        self.sessions = (SessionStore(handle.state_spec, int(sessions_cfg.get("capacity", 64)), device=self.device)
                         if handle.stateful else None)
        self.ckpt_step = int(handle.ckpt_step)
        self.ckpt_path = str(handle.ckpt_path)
        self._steps: Dict[Tuple[int, bool], Callable] = {}
        self._greedy_gen = torch.Generator(device=self.device)
        self._sample_gen = torch.Generator(device=self.device)
        self._sample_gen.manual_seed(time.time_ns() % (2**31))
        self._dispatch_counter = 0
        self.warmup_steps = 0

    def start(self) -> "PolicyService":
        self.batcher.start()
        return self

    def warmup(self) -> None:
        """Run every (bucket, mode) step once on the scratch slot, so the
        first requests pay no one-time costs (cuDNN algorithm choice, the
        kernel build and load)."""
        for bucket in self.buckets:
            for greedy in (True, False):
                obs = self._to_device(self.handle.zero_obs(bucket))
                if self.sessions is None:
                    self._step(bucket, greedy)(self.handle.params, obs, self._generator(greedy))
                    self.warmup_steps += 1
                    continue
                idx = torch.full((bucket,), self.sessions.scratch, dtype=torch.int64, device=self.device)
                is_first = torch.ones((bucket, 1), dtype=torch.float32, device=self.device)
                self._step(bucket, greedy)(self.handle.params, self.sessions.slab, idx, obs, is_first,
                                           self._generator(greedy))
                self.warmup_steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        self.batcher.close()

    def _step(self, width: int, greedy: bool) -> Callable:
        key = (int(width), bool(greedy))
        if key not in self._steps:
            self._steps[key] = (self.handle.make_step(bool(greedy)) if self.sessions is None
                                else make_slab_step(self.handle.make_state_step(bool(greedy))))
        return self._steps[key]

    def _generator(self, greedy: bool) -> torch.Generator:
        if greedy:
            return self._greedy_gen.manual_seed(0)
        return self._sample_gen

    def _to_device(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device) for k, v in obs.items()}

    def _dispatch(self, rows: List[Dict[str, Any]], greedy: bool) -> Tuple[Any, Dict[str, Any]]:
        width = pick_bucket(len(rows), self.buckets)
        if self.sessions is not None:
            return self._dispatch_stateful(rows, greedy, width)
        obs = self._to_device(self.handle.assemble(rows, width))
        self._dispatch_counter += 1
        out = self._step(width, greedy)(self.handle.params, obs, self._generator(greedy)).cpu().numpy()
        meta = {"ckpt_step": self.ckpt_step, "params_version": 0, "batch_width": width, "batch_rows": len(rows),
                "dispatch_id": self._dispatch_counter}
        return out[: len(rows)], meta

    def _dispatch_stateful(self, rows: List[Dict[str, Any]], greedy: bool, width: int) -> Tuple[Any, Dict[str, Any]]:
        """One stateful dispatch: resolve each row's slab slot (LRU checkout),
        then gather/step/scatter.  Padding and sessionless rows ride the
        scratch slot with ``is_first`` forced to 1."""
        obs = self._to_device(self.handle.assemble([r["obs"] for r in rows], width))
        self._dispatch_counter += 1
        idx, is_first, evicted = self.sessions.checkout(
            [r.get("session") for r in rows], [bool(r.get("reset")) for r in rows], width
        )
        actions = self._step(width, greedy)(
            self.handle.params,
            self.sessions.slab,
            torch.from_numpy(idx).to(self.device),
            obs,
            torch.from_numpy(is_first).to(self.device),
            self._generator(greedy),
        )
        out = actions.cpu().numpy()
        meta = {
            "ckpt_step": self.ckpt_step,
            "params_version": 0,
            "batch_width": width,
            "batch_rows": len(rows),
            "dispatch_id": self._dispatch_counter,
            "sessions_active": self.sessions.active,
            "session_evictions": len(evicted),
        }
        return out[: len(rows)], meta

    def act(
        self,
        obs: Any,
        greedy: Optional[bool] = None,
        timeout_s: float = 30.0,
        session: Optional[str] = None,
        reset: bool = False,
        request_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        row = self.handle.validate(obs)
        use_greedy = self.default_greedy if greedy is None else bool(greedy)
        if self.sessions is None:
            if session is not None:
                raise ServeError(400, f"algorithm {self.handle.algo!r} serves statelessly; 'session' is only valid "
                                      "for recurrent/model-based policies")
            return self.batcher.submit(row, use_greedy, timeout_s=timeout_s, request_id=request_id)
        sid = None if session is None else str(session)
        # a non-None group key keeps one session's rows out of the same
        # dispatch: its slab slot is gathered at most once per batch
        return self.batcher.submit(
            {"obs": row, "session": sid, "reset": bool(reset)},
            use_greedy,
            timeout_s=timeout_s,
            group_key=None if sid is None else ("session", sid),
            request_id=request_id,
        )


class ServeApp:
    """What the ``serve`` CLI runs: one policy, its service and the HTTP
    server.  ``start`` returns the bound ``(host, port)``."""

    def __init__(self, cfg, ckpt_path: str, device: torch.device | str):
        self.cfg = cfg
        serving_cfg = dict(cfg.get("serving") or {})
        self.host = str(serving_cfg.get("host", "127.0.0.1"))
        self.port = int(serving_cfg.get("port", 0))
        self.request_timeout_s = float(serving_cfg.get("request_timeout_s", 30.0))
        self._warmup = bool(serving_cfg.get("warmup", True))
        refuse_unported(serving_cfg)
        self.unported_defaults = unported_defaults(serving_cfg)
        self.handle = load_policy(cfg, str(ckpt_path), device)
        self.service = PolicyService(self.handle, serving_cfg)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        service = self.service
        timeout_s = self.request_timeout_s
        self.service.start()
        if self._warmup:
            self.service.warmup()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: Any) -> None:
                pass

            def _reply(self, status: int, body: bytes, headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for header, value in (headers or {}).items():
                    self.send_header(header, value)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:  # noqa: N802 - stdlib API
                if self.path.partition("?")[0] != "/act":
                    self._reply(404, b'{"error": "not found"}')
                    return
                request_id = str(self.headers.get("X-Request-Id") or uuid.uuid4().hex[:16])
                rid_header = {"X-Request-Id": request_id}
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if payload.get("model") not in (None, "default"):
                        raise ServeError(404, f"unknown model {payload.get('model')!r}; this server holds 'default'")
                    result = service.act(
                        payload.get("obs"),
                        greedy=payload.get("greedy"),
                        timeout_s=min(timeout_s, float(payload.get("timeout_s") or timeout_s)),
                        session=payload.get("session"),
                        reset=bool(payload.get("reset", False)),
                        request_id=request_id,
                    )
                except ServeError as err:
                    headers = dict(rid_header)
                    if err.retry_after is not None:
                        headers["Retry-After"] = str(err.retry_after)
                    self._reply(err.status, json.dumps({"error": str(err)}).encode(), headers=headers)
                    return
                except (ValueError, TypeError, json.JSONDecodeError) as err:
                    self._reply(400, json.dumps({"error": str(err)}).encode(), headers=rid_header)
                    return
                except Exception as err:  # noqa: BLE001 - handler must answer
                    self._reply(500, json.dumps({"error": repr(err)}).encode(), headers=rid_header)
                    return
                body = {"action": np.asarray(result["action"]).tolist(), **{k: v for k, v in result.items() if k != "action"}}
                self._reply(200, json.dumps(body).encode(), headers=rid_header)

            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                if self.path.partition("?")[0] != "/healthz":
                    self._reply(404, b'{"error": "not found"}')
                    return
                stats = service.batcher.stats()
                model = {
                    "algo": service.handle.algo,
                    "ckpt_step": service.ckpt_step,
                    "ckpt_path": service.ckpt_path,
                    "requests_total": stats["requests_total"],
                    "stateful": service.sessions is not None,
                }
                if service.sessions is not None:
                    model["sessions"] = {
                        "active": service.sessions.active,
                        "capacity": service.sessions.capacity,
                        "evictions_total": service.sessions.evictions_total,
                    }
                body = {
                    "status": "ok",
                    "algo": service.handle.algo,
                    "ckpt_step": service.ckpt_step,
                    "ckpt_path": service.ckpt_path,
                    "requests_total": stats["requests_total"],
                    "device": str(service.device),
                    "models": {"default": model},
                }
                self._reply(200, json.dumps(body).encode())

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, name="sheeprl-serve-http", daemon=True)
        self._thread.start()
        return self.address

    @property
    def address(self) -> Tuple[str, int]:
        if self._server is None:
            raise RuntimeError("ServeApp not started")
        host, port = self._server.server_address[:2]
        return str(host), int(port)

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.service.close()


def serve_checkpoint(cfg, ckpt_path: str, device: torch.device | str) -> None:
    """Blocking CLI loop: start the app, print the address, serve until
    interrupted."""
    app = ServeApp(cfg, ckpt_path, device)
    if app.unported_defaults:
        print("Off in this server (the JAX package's server runs them): " + "; ".join(app.unported_defaults),
              flush=True)
    host, port = app.start()
    print(
        f"Serving {app.handle.algo} checkpoint (step {app.service.ckpt_step}) on {app.service.device} "
        f"at http://{host}:{port}/act  (health: /healthz)",
        flush=True,
    )
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        app.close()
