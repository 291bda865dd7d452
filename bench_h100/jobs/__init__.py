"""One module a traffic ``kind``: ``detect`` and ``train``. Each builds a
cell's set-up, runs its measured window and checks what the window
produced against ``bench_h100.reference``."""
