"""OpenAI-compatible streaming HTTP front end over ``ServeEngine`` (port
of ``llm_np_cp_tpu/serve/http/``).

Stdlib only (asyncio streams — no web framework): the serving tick loop
runs on a worker thread (``EngineRunner``), which makes every CUDA call,
and the HTTP handlers on the event loop, bridged by per-request asyncio
queues that carry ints and strings.  See ``server`` for the
architecture, ``protocol`` for request/response shapes, ``sse`` for the
streaming wire format, ``client`` for the stdlib clients.
"""

from llm_np_cp_tpu_torch.serve.http.protocol import (
    CompletionPayload,
    HTTPError,
    parse_completion_request,
)
from llm_np_cp_tpu_torch.serve.http.server import (
    EngineRunner,
    HttpServer,
    run_server,
    serve_forever,
)
from llm_np_cp_tpu_torch.serve.http.sse import DONE_SENTINEL, sse_event

__all__ = [
    "CompletionPayload",
    "DONE_SENTINEL",
    "EngineRunner",
    "HTTPError",
    "HttpServer",
    "parse_completion_request",
    "run_server",
    "serve_forever",
    "sse_event",
]
