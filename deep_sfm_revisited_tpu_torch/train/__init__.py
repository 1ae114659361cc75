"""Training and evaluation: the frozen-flow depth-training step (`trainer.py`,
`losses.py`), its loop and checkpoints (`loop.py`, `checkpoint.py`), and the
Eigen-protocol evaluation (`evaluate.py`, `metrics.py`)."""
