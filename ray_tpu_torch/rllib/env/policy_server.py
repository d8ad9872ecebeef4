"""PolicyServerInput + PolicyClient — external simulators over HTTP.

Reference: rllib/env/policy_server_input.py and policy_client.py — an
external sim (game client, robot, browser) owns the env loop and talks to a
policy over HTTP: start_episode / get_action / log_returns / end_episode.
The server answers actions from the live algorithm's policy and accumulates
finished episodes as SampleBatches for offline-style training (BC/MARWIL/CQL
readers accept them directly; on-policy algorithms can train via
``train_on_collected`` callbacks).

The standard library's ``http.server`` and ``urllib``, as in the JAX
package. An action served to a client is the ``compute_action`` it was given,
typically ``Algorithm.compute_single_action``: one forward on the
algorithm's device (the card unless its config asks for the CPU) and one read
a request, under the server's policy lock. As ``config.input_`` of an
offline-capable algorithm the server is read by
``offline.ExternalInputReader`` (``make_input_reader`` picks it by its
``next_batch``).
"""

from __future__ import annotations

import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    EPS_ID,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
)


class _Episode:
    def __init__(self, eid: str, idx: int):
        self.eid = eid
        self.idx = idx
        self.obs: list = []
        self.actions: list = []
        self.rewards: list = []


class PolicyServerInput:
    """Serve a policy to external clients; collect their episodes.

    ``compute_action(obs_np, explore) -> action`` is typically an
    ``Algorithm.compute_single_action`` bound method.
    """

    def __init__(self, compute_action: Callable, host: str = "127.0.0.1", port: int = 0):
        self.compute_action = compute_action
        self._episodes: dict[str, _Episode] = {}
        self._next_idx = 0
        self._completed: list[_Episode] = []
        self._lock = threading.Lock()
        # Policy calls get their own lock: compute_action typically mutates
        # algorithm RNG state (not thread-safe), but it must not serialize
        # unrelated episode bookkeeping.
        self._policy_lock = threading.Lock()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    out = outer._dispatch(self.path, payload)
                    body = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 — surfaced to the client
                    body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.address = f"http://{host}:{self._server.server_port}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def _dispatch(self, path: str, payload: dict) -> dict:
        if path == "/get_action":
            # Policy forward outside the episode lock (it can take
            # milliseconds), but serialized against other policy calls —
            # compute_action mutates shared RNG state.
            obs = np.asarray(payload["observation"], np.float32)
            with self._policy_lock:
                action = self.compute_action(obs, bool(payload.get("explore", True)))
            with self._lock:
                ep = self._episodes.get(payload.get("episode_id", ""))
                if ep is None:
                    raise KeyError(f"unknown episode {payload.get('episode_id')!r}")
                ep.obs.append(obs)
                ep.actions.append(np.asarray(action))
                ep.rewards.append(0.0)  # accumulated by log_returns
            return {"action": np.asarray(action).tolist()}
        with self._lock:
            if path == "/start_episode":
                eid = payload.get("episode_id") or uuid.uuid4().hex[:12]
                self._episodes[eid] = _Episode(eid, self._next_idx)
                self._next_idx += 1
                return {"episode_id": eid}
            ep = self._episodes.get(payload.get("episode_id", ""))
            if ep is None:
                raise KeyError(f"unknown episode {payload.get('episode_id')!r}")
            if path == "/log_action":
                # Client-side action (off-policy logging).
                ep.obs.append(np.asarray(payload["observation"], np.float32))
                ep.actions.append(np.asarray(payload["action"]))
                ep.rewards.append(0.0)
                return {}
            if path == "/log_returns":
                # Rewards ACCUMULATE onto the current step (the reference's
                # PolicyClient semantics — several shaping rewards per action,
                # or none, are both legal).
                if not ep.rewards:
                    raise RuntimeError("log_returns before any get_action/log_action")
                ep.rewards[-1] += float(payload["reward"])
                return {}
            if path == "/end_episode":
                self._episodes.pop(ep.eid)
                n = len(ep.actions)
                if n:
                    self._completed.append(ep)
                return {"rows": n}
            raise ValueError(f"unknown endpoint {path}")

    def num_completed(self) -> int:
        with self._lock:
            return len(self._completed)

    def next_batch(self, min_episodes: int = 1) -> Optional[SampleBatch]:
        """Drain completed episodes into one SampleBatch (rows in time
        order, EPS_ID marking boundaries; NEXT_OBS shifted within episodes)."""
        with self._lock:
            if len(self._completed) < min_episodes:
                return None
            eps, self._completed = self._completed, []
        frags = []
        for ep in eps:
            obs = np.stack(ep.obs)
            next_obs = np.concatenate([obs[1:], obs[-1:]])
            dones = np.zeros(len(obs), np.float32)
            dones[-1] = 1.0
            frags.append(SampleBatch({
                OBS: obs,
                ACTIONS: np.stack(ep.actions),
                REWARDS: np.asarray(ep.rewards, np.float32),
                DONES: dones,
                NEXT_OBS: next_obs,
                EPS_ID: np.full(len(obs), ep.idx, np.int64),
            }))
        return SampleBatch.concat_samples(frags)

    def shutdown(self):
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass


class PolicyClient:
    """Client side for external sims (reference: policy_client.py)."""

    def __init__(self, address: str, timeout: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            self.address + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if isinstance(out, dict) and out.get("error"):
            raise RuntimeError(out["error"])
        return out

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        return self._post("/start_episode", {"episode_id": episode_id})["episode_id"]

    def get_action(self, episode_id: str, observation, explore: bool = True):
        out = self._post("/get_action", {
            "episode_id": episode_id,
            "observation": np.asarray(observation).tolist(),
            "explore": explore,
        })
        a = out["action"]
        return a if np.isscalar(a) else np.asarray(a)

    def log_action(self, episode_id: str, observation, action):
        self._post("/log_action", {
            "episode_id": episode_id,
            "observation": np.asarray(observation).tolist(),
            "action": np.asarray(action).tolist(),
        })

    def log_returns(self, episode_id: str, reward: float):
        self._post("/log_returns", {"episode_id": episode_id, "reward": float(reward)})

    def end_episode(self, episode_id: str, observation=None) -> int:
        return self._post("/end_episode", {"episode_id": episode_id}).get("rows", 0)
