"""Open-retrieval QA: the retriever evaluation and supervised finetuning."""
