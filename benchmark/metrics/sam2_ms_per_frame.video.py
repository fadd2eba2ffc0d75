"""SAM2's milliseconds per frame: the spans around each propagate_batched
batch (synchronised at both ends) over the frames they propagated."""


def read(data: dict):
    n = data["sam2_frames"]
    return 1e3 * data["span_s"]["sam2"] / n if n else None
