"""The H100 benchmark of ``noize_tpu_torch``: one command runs one cell
(``python3 -m h100bench.run --workload <name> ...``); see README.md."""
