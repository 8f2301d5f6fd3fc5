"""pvtrace_tpu_torch studio — browser-based scene editor and live simulator.

Parity: reference ``pvtrace/studio`` (FastAPI + three.js + websockets).
This implementation is dependency-free: a stdlib ``http.server``
backend, Server-Sent Events for live result streaming (instead of a
websocket), and a hand-written canvas/WebGL-free 3D wireframe viewport
(instead of three.js). The YAML document remains the single source of
truth; GUI edits go through structured ``/api/patch`` operations.
"""
from pvtrace_tpu_torch.studio.server import Studio, create_server, main  # noqa: F401
