"""Kernel launches the profiler saw on the card per frame of the staged
cell's profiled video."""


def read(data: dict):
    prof = data.get("profile")
    if prof is None or not prof["frames"]:
        return None
    return prof["launches"] / prof["frames"]
