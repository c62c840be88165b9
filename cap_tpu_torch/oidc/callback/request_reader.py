"""RequestReader: look up an in-flight oidc.Request by state.
Implementations must be safe for concurrent use by several callback
requests.
"""

from __future__ import annotations

from typing import Optional

from ..request import Request


class RequestReader:
    def read(self, state: str) -> Optional[Request]:
        """Return the Request for ``state``, or None when unknown."""
        raise NotImplementedError


class SingleRequestReader(RequestReader):
    """Trivial reader for apps with one in-flight request."""

    def __init__(self, request: Request):
        self.request = request

    def read(self, state: str) -> Optional[Request]:
        return self.request if self.request.state() == state else None
