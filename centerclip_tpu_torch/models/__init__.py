# coding=utf-8
"""CLIP towers (ViT and ResNet), CLIP4Clip and its similarity headers, the
cross model, tokenizer and weight conversion."""
