"""The repository's example scripts (examples/*.py) for the port: one
module a script, each run as

    python -m ouster_sdk_tpu_torch.examples.scripts.<name> <arguments>

with the root script's arguments, printing its text and writing its files
under the same default names in the working directory. Each imports only
ouster_sdk_tpu_torch, torch and numpy, and runs nothing at import. Their
sources and pipelines take the port's default device, CUDA; the root
examples/tpu_pipeline.py is device_pipeline here."""
