from .synthetic import (
    SynthConfig,
    make_genome,
    simulate_read,
    write_read_fast5,
    generate_dataset,
    write_move_dataset_pod5,
)
