"""Project folder management (reference: src/data_structures/project_io.cpp:15-62).

A project is a folder containing a ``project.txt`` marker; creating over an
existing project requires overwrite, which clears the folder contents.
"""

from __future__ import annotations

import os
import shutil

MARKER = "project.txt"


def is_project(folder: str) -> bool:
    return os.path.isfile(os.path.join(folder, MARKER))


def clean_existing_project(folder: str) -> None:
    for entry in os.listdir(folder):
        p = os.path.join(folder, entry)
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)


def create_project(folder: str, overwrite: bool = False) -> bool:
    """Create (or reset) a project folder. Returns False when the folder holds
    a project already and overwrite was not requested."""
    if os.path.isdir(folder):
        if is_project(folder):
            if not overwrite:
                print("Error: The specified project folder already contains a project. "
                      "Use --overwrite to reset it.")
                return False
            clean_existing_project(folder)
    else:
        os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, MARKER), "w") as f:
        f.write("OrthoSfM project\n")
    return True
