"""The share of a BOP cell's profiled image's wall time in which no
operation ran on the card, in %."""


def read(data: dict):
    prof = data.get("profile")
    if prof is None or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
