# coding=utf-8
"""CLIP towers, CLIP4Clip (meanP), tokenizer and weight conversion."""
