"""Zero-shot LM evaluation: WikiText-103 perplexity and LAMBADA accuracy."""
