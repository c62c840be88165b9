"""OIDC display values (OpenID Connect Core 1.0 §3.1.2.1)."""


class Display(str):
    pass


PAGE = Display("page")
POPUP = Display("popup")
TOUCH = Display("touch")
WAP = Display("wap")
