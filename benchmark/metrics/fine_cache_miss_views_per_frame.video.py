"""Fine-grid views the refine rendered and featurized per refined frame:
the program's own count, AutoRefineChain.miss_counts (the cold frame's
whole neighbourhood included)."""


def read(data: dict):
    misses = data["miss_counts"]
    return sum(misses) / len(misses) if misses else None
