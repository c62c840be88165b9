"""OIDC prompt values (OpenID Connect Core 1.0 §3.1.2.1)."""


class Prompt(str):
    pass


NONE = Prompt("none")
LOGIN = Prompt("login")
CONSENT = Prompt("consent")
SELECT_ACCOUNT = Prompt("select_account")
