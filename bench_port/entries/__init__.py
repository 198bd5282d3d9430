"""Adapters from the benchmark to graphminer_tpu_torch, one module an entry
(a configuration's "entry"). Each has

    prepare(rowptr, colidx, config, devices, span) -> object with count()

rowptr (int64 [V + 1]) and colidx (int32) are the generated symmetric CSR
on the host; `devices` the torch devices of the cell's chips; `span(name,
devices)` a context manager that times a part of set-up on the host clock
(ending in a synchronize of the devices it is given). count() returns the
exact count as a Python int; the object holds all of the program's state.
"""
