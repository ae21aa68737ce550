"""Port allocation for local rendezvous and servers — the port's copy of
``kubeflow_tpu/utils/net.py``.

The reference relies on k8s Services/DNS for worker addressing; with local
processes we hand out loopback ports instead. Ports are reserved by binding
then releasing, with a process-wide recently-used set to avoid re-handing
a port before its worker binds it.
"""

from __future__ import annotations

import socket
import threading
from typing import List

_recent_lock = threading.Lock()
_recent: set = set()
_RECENT_MAX = 512


def free_port(host: str = "127.0.0.1") -> int:
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            port = s.getsockname()[1]
        with _recent_lock:
            if port in _recent:
                continue
            _recent.add(port)
            if len(_recent) > _RECENT_MAX:
                _recent.clear()
                _recent.add(port)
            return port


def free_ports(n: int, host: str = "127.0.0.1") -> List[int]:
    return [free_port(host) for _ in range(n)]
