"""The port's C ABI (`usearch_torch.cabi`) on the CPU: its C and C++ smoke
tests (usearch_torch/cabi/test.c, test.cpp) built over libusearch_torch.so
and run with ``USEARCH_TORCH_DEVICE=cpu``, once more with JAX and the JAX
package made unimportable, the refusal to start without a card, the JAX
package's unchanged c/test.c and cpp/test.cpp linked against the port's
library, and the two headers held declaration for declaration."""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from usearch_torch import cabi  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None or shutil.which("cc") is None,
                                reason="no C/C++ toolchain")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SITE = [p for p in sys.path if p.endswith(("site-packages", "dist-packages"))]
#: each program's wall-clock bound: an embedded interpreter imports torch
RUN_TIMEOUT = 120
#: modules the library and its helper must never import
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "usearch_tpu")


def program_env(*front: str, device: str = "cpu") -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([*front, REPO, *SITE])
    env.pop("USEARCH_TORCH_DEVICE", None)
    if device is not None:
        env["USEARCH_TORCH_DEVICE"] = device
    return env


NO_CARD = textwrap.dedent("""
    import ctypes
    from usearch_torch import cabi

    lib = cabi.library()
    err = ctypes.c_char_p(None)
    opts = cabi.InitOptions(metric_kind=cabi.METRICS["ip"], quantization=cabi.SCALARS["f32"], dimensions=4)
    handle = lib.usearch_init(ctypes.byref(opts), ctypes.byref(err))
    print(handle, err.value.decode() if err.value else None)
""")


def blocking_site(site, log) -> None:
    """A sitecustomize.py in ``site`` that refuses `BLOCKED` and logs its
    start and every refusal to ``log``."""
    site.mkdir()
    (site / "sitecustomize.py").write_text(textwrap.dedent(f"""
        import sys

        BLOCKED = {BLOCKED!r}
        LOG = {str(log)!r}


        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    with open(LOG, "a") as f:
                        f.write(name + "\\n")
                    raise ModuleNotFoundError(f"{{name}} is blocked", name=name)
                return None


        sys.meta_path.insert(0, Refuse())
        with open(LOG, "a") as f:
            f.write("installed\\n")
    """))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The programs that start an interpreter, all started at once (each
    imports torch): the port's test.c and test.cpp built over
    libusearch_torch.so and run on the CPU, test.c again under a
    sitecustomize refusing `BLOCKED`, and a Python process asking for an
    index with no card and no device request."""
    out = tmp_path_factory.mktemp("cabi_programs")
    test_c = cabi.build_program(os.path.join(cabi.SRC_DIR, "test.c"), out / "test_c")
    test_cpp = cabi.build_program(os.path.join(cabi.SRC_DIR, "test.cpp"), out / "test_cpp")
    blocking_site(out / "site", out / "blocked.log")
    no_card = program_env(device=None)
    no_card["CUDA_VISIBLE_DEVICES"] = ""  # no card, wherever the test runs
    commands = {
        "c": ([str(test_c), str(out / "c.usearch")], program_env()),
        "cpp": ([str(test_cpp), str(out / "cpp.usearch")], program_env()),
        "blocked": ([str(test_c), str(out / "blocked.usearch")], program_env(str(out / "site"))),
        "no_card": ([sys.executable, "-c", NO_CARD], no_card),
    }
    procs = {name: subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, (cmd, env) in commands.items()}
    done = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=RUN_TIMEOUT)
            done[name] = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    done["blocked_log"] = (out / "blocked.log").read_text().splitlines()
    return done


def test_library_builds_to_its_fixed_name():
    path = cabi.build()
    assert path == cabi.LIBRARY and path.name == "libusearch_torch.so"
    assert path.parent.parts[-2:] == ("_build", "cabi")
    assert cabi.build() == path  # the stamp matches: no rebuild
    exported = subprocess.run(["nm", "-D", "--defined-only", str(path)], capture_output=True, text=True,
                              check=True).stdout
    names = {line.split()[-1] for line in exported.splitlines() if " T " in line}
    assert names == set(cabi.SIGNATURES), "the library must export the header's functions and nothing else"


def test_c_round_trip(runs):
    out = runs["c"]
    assert out.returncode == 0, out.stderr[-2000:]
    assert "C ABI test passed (version 2.21.0+torch.0.1, cpu)" in out.stdout


def test_cpp_wrapper_round_trip(runs):
    out = runs["cpp"]
    assert out.returncode == 0, out.stderr[-2000:]
    assert "C++ wrapper test passed" in out.stdout


def test_c_round_trip_needs_no_jax(runs):
    """test.c again with a sitecustomize that refuses JAX, ml_dtypes and
    the JAX package: the library and its helper import none of them."""
    out = runs["blocked"]
    assert out.returncode == 0, out.stderr[-2000:]
    assert "C ABI test passed" in out.stdout
    assert runs["blocked_log"] == ["installed"], "a blocked module was imported"


def test_init_without_a_card_fails(runs):
    """No card and no USEARCH_TORCH_DEVICE: usearch_init returns NULL with
    an error naming the missing device (never a quiet CPU run)."""
    out = runs["no_card"]
    assert out.returncode == 0, out.stderr[-2000:]
    handle, _, message = out.stdout.strip().partition(" ")
    assert handle == "None"
    assert "no CUDA device is available" in message


@pytest.mark.parametrize("binding", ["c/test.c", "cpp/test.cpp"])
def test_unchanged_bindings_link_against_the_port(binding, tmp_path):
    """The JAX package's own C test and C++ wrapper test, compiled against
    c/usearch_tpu.h, link against libusearch_torch.so (link only): every
    binding switches engine by the library alone."""
    source = os.path.join(REPO, binding)
    out = cabi.build_program(source, tmp_path / "linked", include_dir=os.path.dirname(source))
    needed = subprocess.run(["readelf", "-d", str(out)], capture_output=True, text=True, check=True).stdout
    assert "[libusearch_torch.so]" in needed and "usearch_tpu" not in needed


def _declarations(path: str) -> list:
    """The header's top-level declarations, comments, preprocessor lines and
    the C++ guard removed, whitespace collapsed."""
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    text = "\n".join(line for line in text.splitlines() if not line.strip().startswith("#"))
    text = text.replace('extern "C" {', " ")
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"\s*([(),;{}*=])\s*", r"\1", text)
    decls, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        if ch == "{":
            depth += 1
        elif ch == "}":
            if depth == 0:  # the C++ guard's closing brace
                start = i + 1
                continue
            depth -= 1
        elif ch == ";" and depth == 0:
            decls.append(text[start:i].strip())
            start = i + 1
    return [d for d in decls if d]


def _enums(decls: list) -> dict:
    out = {}
    for d in decls:
        m = re.match(r"typedef enum (\w+)\{(.*)\}(\w+)$", d)
        if m:
            value, values = -1, {}
            for item in filter(None, m.group(2).split(",")):
                name, _, given = item.partition("=")
                value = int(given) if given else value + 1
                values[name] = value
            out[m.group(3)] = values
    return out


def _functions(decls: list) -> dict:
    return {re.search(r"(usearch_\w+)\(", d).group(1): d for d in decls if re.search(r"\busearch_\w+\(", d)
            and not d.startswith("typedef")}


def test_headers_declare_the_same_abi():
    """usearch_torch.h against c/usearch_tpu.h, declaration for
    declaration: prototypes, enum values, the options struct, typedefs; and
    the loader's ctypes constants against the header."""
    mine = _declarations(str(cabi.HEADER))
    theirs = _declarations(os.path.join(REPO, "c", "usearch_tpu.h"))
    assert mine == theirs
    functions = _functions(mine)
    assert len(functions) == 38 and set(functions) == set(cabi.SIGNATURES)
    assert functions == _functions(theirs)
    enums = _enums(mine)
    assert enums == _enums(theirs)
    assert {k.removeprefix("usearch_metric_").removesuffix("_k"): v
            for k, v in enums["usearch_metric_kind_t"].items()} == cabi.METRICS
    assert {k.removeprefix("usearch_scalar_").removesuffix("_k"): v
            for k, v in enums["usearch_scalar_kind_t"].items()} == cabi.SCALARS
    struct = next(d for d in mine if d.startswith("typedef struct usearch_init_options_t"))
    fields = [f.split()[-1] for f in struct.split("{", 1)[1].rsplit("}", 1)[0].split(";") if f]
    assert fields == [name for name, _ in cabi.InitOptions._fields_]
    assert ctypes.sizeof(cabi.InitOptions) == 64
