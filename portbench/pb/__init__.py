"""The harness of the port's benchmark: what a cell is (``spec``), its
inputs (``data``), the program driven as ``train_nn --epochs N``
(``program``), the plain reference (``reference``, ``glibc``) and the
comparison that decides ``correct`` (``check``, ``lines``), the faults
planted for that comparison's readings (``faults``), the traced run's
device view (``tracing``), and one run end to end (``cell``)."""
