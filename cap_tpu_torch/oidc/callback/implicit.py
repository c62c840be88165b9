"""Implicit-flow (form_post) callback handler.

Reads the posted id_token (and access_token, when one was asked for),
finds and checks the Request, runs ``provider.verify_id_token``, checks
at_hash when an access token was asked for and posted, and wraps the
result into a Token.
"""

from __future__ import annotations

from typing import Callable

from ...errors import (
    ExpiredRequestError,
    InvalidFlowError,
    MissingIDTokenError,
    NotFoundError,
)
from ..id_token import IDToken
from ..provider import Provider
from ..token import Token
from .authcode import _params, _respond
from .request_reader import RequestReader
from .response_func import AuthenErrorResponse


def implicit(p: Provider, request_reader: RequestReader,
             success_fn: Callable, error_fn: Callable):
    """Build the WSGI callback app for the implicit flow."""
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
        with_implicit, with_access_token = request.implicit_flow()
        if not with_implicit:
            return _respond(start_response, error_fn(
                state, None,
                InvalidFlowError(
                    "request does not use the implicit flow but callback "
                    "is for the implicit flow"), environ))
        raw_id_token = params.get("id_token", "")
        if not raw_id_token:
            return _respond(start_response, error_fn(
                state, None,
                MissingIDTokenError("id_token is missing"), environ))
        id_token = IDToken(raw_id_token)
        try:
            p.verify_id_token(id_token, request)
        except Exception as e:  # noqa: BLE001
            return _respond(start_response,
                            error_fn(state, None, e, environ))
        access_token = params.get("access_token", "")
        if with_access_token and access_token:
            try:
                id_token.verify_access_token(access_token)
            except Exception as e:  # noqa: BLE001
                return _respond(start_response,
                                error_fn(state, None, e, environ))
        try:
            token = Token(id_token, access_token=access_token,
                          now_func=p.config.now_func)
        except Exception as e:  # noqa: BLE001
            return _respond(start_response,
                            error_fn(state, None, e, environ))
        return _respond(start_response,
                        success_fn(state, token, environ))

    return app
