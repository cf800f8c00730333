"""portbench: the benchmark of ouster_sdk_tpu_torch on one NVIDIA H100.

One run measures one cell of BENCHMARK.json (a sensor configuration under
a traffic mix) and prints one JSON line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that defines a cell sits in files found by name:
configs/<config>.json (the sensor's metadata and what was assumed),
traffic/<mix>.json (the parameters a driver reads), drivers/<driver>.py
(what the measured window drives and how its output is checked) and
metrics/<metric>.py (a metric's own reader) or metrics/<metric>.json (a
shared reader of readers/ and its arguments). The inputs (lib/synth.py,
lib/yard.py) and the plain reference (reference/) import nothing of the
program.
"""
