"""The benchmark of `rpt_tpu_torch`, the PyTorch and CUDA port, on one card.

One run measures one cell (a configuration under a traffic mix) through the
port's public entry, `rpt_tpu_torch.Renderer`, and prints one JSON line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything here is data-driven: a cell names a configuration
(`configs/<name>.json` and its scene builder `configs/<name>.py`), a traffic
mix (`traffic/<name>.json`) and the limits of its correctness check
(`checks/<cell>.json`); a per-layer metric is read by `metrics/<name>.py`.
The yardstick (traffic generation, the ray arithmetic, the peaks, the trace
reduction and the plain reference that decides `correct`) lives in this
package and imports nothing of JAX or of the JAX package.
"""
