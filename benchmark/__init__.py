"""The benchmark of devc_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line. Everything that belongs to one configuration, traffic mix or metric
sits in a file of its own, found by the name BENCHMARK.json gives:
configs/<config>.json (sizes), traffic/<mix>.json (the mix's parameters,
among them the driver in drivers/ that runs it), metrics/<metric>.py (a
reader). reference/ is the plain PyTorch the outputs are judged against;
it imports nothing of the port, and nothing here imports JAX or the JAX
package."""
