"""Downstream tasks on the encoder (port of the root tasks/ package):
GLUE (MNLI, QQP) and RACE classification finetuning through
`tasks.main`."""
