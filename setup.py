"""Packaging hook: ship the C++ runtime source inside the wheel.

The native runtime (native/indexer.cpp) is compiled on first use with the
host's g++ (-march=native), never pre-built — so the SOURCE must travel
with the installed package.  This copies it into
``searcharray_tpu/_native_src/`` and ``searcharray_tpu_torch/_native_src/``
at build time; each package's ``index/native.py`` looks there when the
repo-layout path is absent (pip-installed case).
"""
import os
import shutil

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithNativeSrc(build_py):
    def run(self):
        super().run()
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(here, "native", "indexer.cpp")
        for pkg in ("searcharray_tpu", "searcharray_tpu_torch"):
            dst_dir = os.path.join(self.build_lib, pkg, "_native_src")
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copy(src, dst_dir)


setup(cmdclass={"build_py": BuildPyWithNativeSrc})
