"""The benchmark of sqlite_vector_tpu_torch: VectorDBBench's search cases
run through the port's own entry points on one NVIDIA H100.

One run of one cell: `python3 vbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout. Everything that
belongs to one configuration (`configs/<name>.json`), one traffic mix
(`traffic/<name>.json`), one metric (`metrics/<name>.py`) or one plain
reference (`reference/<name>.py`) sits in a file of its own that the
harness finds by the name `BENCHMARK.json` gives it.

Nothing here imports jax or the JAX package; the references import nothing
of the port either.
"""
