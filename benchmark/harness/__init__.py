"""The benchmark's harness: the cell's files by name (`spec`), the system
and its traffic (`system`), a run (`cell`), the trace's reading (`trace`),
the roofline arithmetic (`bounds`) and the process environment (`env`)."""
