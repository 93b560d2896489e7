"""The benchmark's general machinery: cells, configurations and traffic
read from data files, the program driven through its public entry, the
profiler's trace reduced to metrics, and the comparison that decides
``correct``."""
