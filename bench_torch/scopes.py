"""The program's timer scopes (``rails_tpu_torch/timer.py``) as the
window's requests recorded them: ``{"Driver/load": (seconds, calls)}``
per request."""


def ms(records, scope: str, per: str):
    """The scope's milliseconds per request (``per="request"``) or per
    call (``per="call"``), over the requests that have it; None where
    none has."""
    got = [r["scopes"][scope] for r in records
           if scope in r.get("scopes", {})]
    if not got:
        return None
    n = len(got) if per == "request" else sum(c for _, c in got)
    return 1e3 * sum(s for s, _ in got) / n
