"""Evaluation (the Eigen protocol); training is not ported yet."""
