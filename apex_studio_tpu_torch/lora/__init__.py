"""LoRA format handling and merge into resident weights."""
