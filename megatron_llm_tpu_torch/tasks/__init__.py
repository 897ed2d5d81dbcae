"""Downstream tasks (port of the root tasks/ package), run through
`tasks.main`: GLUE (MNLI, QQP) and RACE classification finetuning,
zero-shot WikiText-103 and LAMBADA evaluation, MSDP prompting and F1,
and the ORQA retriever's evaluation and supervised finetuning."""
