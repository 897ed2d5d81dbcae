"""Multi-stage dialogue prompting (MSDP): preprocessing, prompting and F1."""
