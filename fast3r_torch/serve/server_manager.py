"""Per-session visualisation servers and the demo's feedback file.

Counterpart of ``fast3r_tpu/serve/server_manager.py``: the Gradio demo
(``serve/demo.py``) starts one Viser server process per user session from
a pool of ports, keeps them in a registry and collects the idle ones; the
feedback box appends JSON lines to a file.  The spawn target is
injectable, so the manager runs (and is tested) without viser.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import time
from typing import Callable, Dict, Optional, Tuple


class ViserServerManager:
    """A registry of per-session server processes over a pool of ports."""

    def __init__(self, port_range: Tuple[int, int] = (8020, 8100),
                 target: Optional[Callable] = None):
        self.port_range = port_range
        self._target = target
        self._sessions: Dict[str, Dict] = {}
        self._ctx = mp.get_context("spawn")

    def _default_target(self):
        from fast3r_torch.serve.viser_server import run_viser_server

        return run_viser_server

    def _free_port(self) -> int:
        used = {s["port"] for s in self._sessions.values()}
        for port in range(self.port_range[0], self.port_range[1] + 1):
            if port not in used:
                return port
        raise RuntimeError(
            f"no free port in {self.port_range}; run gc() or stop sessions")

    def start_server(self, session_id: str, *args, **kwargs) -> int:
        """Start a server process for ``session_id`` (the target called with
        ``args``, ``kwargs`` and ``port``); returns its port.  A session
        already running is restarted: the latest wins."""
        self.stop_server(session_id)
        port = self._free_port()
        target = self._target or self._default_target()
        proc = self._ctx.Process(target=target, args=args,
                                 kwargs={**kwargs, "port": port}, daemon=True)
        proc.start()
        self._sessions[session_id] = {"proc": proc, "port": port,
                                      "started": time.time()}
        return port

    def touch(self, session_id: str) -> None:
        if session_id in self._sessions:
            self._sessions[session_id]["started"] = time.time()

    def stop_server(self, session_id: str) -> bool:
        info = self._sessions.pop(session_id, None)
        if info is None:
            return False
        if info["proc"].is_alive():
            info["proc"].terminate()
            info["proc"].join(timeout=5)
        return True

    def gc(self, max_age_s: float = 3600.0) -> int:
        """Stop the sessions older than ``max_age_s`` and those whose
        process has died; returns how many were collected."""
        now = time.time()
        stale = [sid for sid, info in self._sessions.items()
                 if now - info["started"] > max_age_s
                 or not info["proc"].is_alive()]
        for sid in stale:
            self.stop_server(sid)
        return len(stale)

    def shutdown(self) -> None:
        for sid in list(self._sessions):
            self.stop_server(sid)

    def __len__(self):
        return len(self._sessions)


def save_feedback(path: str, text: str, meta: Optional[Dict] = None) -> str:
    """Append one feedback record as a JSON line: its time, the text and
    ``meta``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rec = {"time": time.time(), "text": text, **(meta or {})}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path
