"""Stability middleware: token-bucket rate limiting + GET response coalescing
(port of ``apex_studio_tpu/server/stability.py``).

Counterpart of the reference's ``api/stability.py:149``
(install_stability_middleware): shields the server from chatty editor pollers
by (a) rate-limiting per client IP with a token bucket and (b) coalescing
concurrent identical GETs into one handler execution whose response is shared.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict

from aiohttp import web

# Poll endpoints the editor hammers; only these are coalesced.
_COALESCE_PREFIXES = ("/ray/jobs", "/engine/status", "/jobs/status", "/system/memory")


class TokenBucket:
    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.burst = burst
        self.tokens = float(burst)
        self.last = time.monotonic()

    def allow(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def install_stability_middleware(
    app: web.Application,
    rate: float = 50.0,
    burst: int = 100,
) -> None:
    buckets: Dict[str, TokenBucket] = {}
    inflight: Dict[str, asyncio.Future] = {}

    @web.middleware
    async def stability(request: web.Request, handler):
        # 1. Rate limit per remote address (websockets exempt).
        if not request.path.startswith("/ws/"):
            ip = request.remote or "local"
            bucket = buckets.setdefault(ip, TokenBucket(rate, burst))
            if not bucket.allow():
                return web.json_response({"detail": "rate limited"}, status=429)

        # 2. Coalesce identical concurrent GET polls.
        if request.method == "GET" and request.path.startswith(_COALESCE_PREFIXES):
            key = request.path_qs
            fut = inflight.get(key)
            if fut is not None:
                body, status, ctype = await asyncio.shield(fut)
                return web.Response(body=body, status=status, content_type=ctype)
            fut = asyncio.get_running_loop().create_future()
            inflight[key] = fut
            try:
                resp = await handler(request)
                body = resp.body if isinstance(resp, web.Response) else b""
                fut.set_result((body, resp.status, resp.content_type))
                return resp
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
                raise
            finally:
                inflight.pop(key, None)

        return await handler(request)

    app.middlewares.append(stability)
