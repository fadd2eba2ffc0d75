"""The fine refine's milliseconds per refined frame: the spans around
AutoRefineChain.submit and finalize_all (synchronised at both ends) over
the frames refined."""


def read(data: dict):
    n = data["refine_frames"]
    return 1e3 * data["span_s"]["refine"] / n if n else None
