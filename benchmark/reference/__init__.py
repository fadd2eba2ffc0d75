"""The plain reference the benchmark judges the program's outputs by: the
frozen float32 models of `frozen/`, the pose arithmetic of `pose.py` and
SAM2's frame-at-a-time tracking of `sam2_track.py`. It imports nothing of
the program and takes nothing it made: weights come from the benchmark's
seed (benchmark/weights.py), templates and the fine grid are rendered and
featurized here again."""
