"""Authorization-code (+PKCE) callback handler.

A factory returning a WSGI app that reads the state, code and error
parameters, finds the in-flight Request through the RequestReader,
checks it (found, not expired, not implicit), runs
``provider.exchange``, and hands the outcome to the success or error
callable.
"""

from __future__ import annotations

from typing import Callable
from urllib.parse import parse_qs

from ...errors import ExpiredRequestError, InvalidFlowError, NotFoundError
from ..provider import Provider
from .request_reader import RequestReader
from .response_func import AuthenErrorResponse


def _params(environ) -> dict:
    query = parse_qs(environ.get("QUERY_STRING", ""))
    if environ.get("REQUEST_METHOD") == "POST":
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if length:
            body = environ["wsgi.input"].read(length).decode("utf-8")
            for k, v in parse_qs(body).items():
                query.setdefault(k, v)
    return {k: v[0] for k, v in query.items() if v}


def _respond(start_response, triple):
    status, headers, body = triple
    reason = {200: "OK", 302: "Found", 400: "Bad Request",
              401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
              500: "Internal Server Error"}.get(status, "")
    start_response(f"{status} {reason}".strip(), list(headers))
    return [body if isinstance(body, bytes) else body.encode("utf-8")]


def auth_code(p: Provider, request_reader: RequestReader,
              success_fn: Callable, error_fn: Callable):
    """Build the WSGI callback app for the authorization-code flow."""
    if p is None:
        raise NotFoundError("provider is nil")
    if request_reader is None:
        raise NotFoundError("request reader is nil")

    def app(environ, start_response):
        params = _params(environ)
        state = params.get("state", "")
        if params.get("error"):
            resp = AuthenErrorResponse(
                error=params["error"],
                description=params.get("error_description", ""),
                uri=params.get("error_uri", ""),
            )
            return _respond(start_response,
                            error_fn(state, resp, None, environ))
        code = params.get("code", "")
        try:
            request = request_reader.read(state)
        except Exception as e:  # noqa: BLE001
            return _respond(start_response,
                            error_fn(state, None, e, environ))
        if request is None:
            return _respond(start_response, error_fn(
                state, None,
                NotFoundError("no request found for state"), environ))
        if request.is_expired():
            return _respond(start_response, error_fn(
                state, None,
                ExpiredRequestError("request is expired"), environ))
        implicit, _ = request.implicit_flow()
        if implicit:
            return _respond(start_response, error_fn(
                state, None,
                InvalidFlowError(
                    "request uses implicit flow but callback is for the "
                    "authorization code flow"), environ))
        try:
            token = p.exchange(request, state, code)
        except Exception as e:  # noqa: BLE001
            return _respond(start_response,
                            error_fn(state, None, e, environ))
        return _respond(start_response,
                        success_fn(state, token, environ))

    return app
