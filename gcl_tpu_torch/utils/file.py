"""File helpers (a copy of gcl_tpu/utils/file.py)."""
from __future__ import annotations

import os
import re


def read_txt(path):
    """Read lines of a text file."""
    with open(path) as f:
        return f.read().splitlines()


def ensure_dir(path):
    if not os.path.exists(path):
        os.makedirs(path, mode=0o755, exist_ok=True)


def sorted_alphanum(file_list_ordered):
    def convert(text):
        return int(text) if text.isdigit() else text

    def alphanum_key(key):
        return [convert(c) for c in re.split("([0-9]+)", key)]

    return sorted(file_list_ordered, key=alphanum_key)


def get_file_list(path, extension=None):
    if extension is None:
        file_list = [os.path.join(path, f) for f in os.listdir(path)
                     if os.path.isfile(os.path.join(path, f))]
    else:
        file_list = [os.path.join(path, f) for f in os.listdir(path)
                     if os.path.isfile(os.path.join(path, f))
                     and os.path.splitext(f)[1] == extension]
    return sorted_alphanum(file_list)


def get_folder_list(path):
    return sorted_alphanum([
        os.path.join(path, f) for f in os.listdir(path)
        if os.path.isdir(os.path.join(path, f))])
