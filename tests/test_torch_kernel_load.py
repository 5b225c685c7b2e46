"""Kernel libraries under threads: the wall-clock runtime's worker threads
launch kernels beside the server thread. On the CPU nothing is built: a
fake library stands in for a built one, and concurrent ``load`` calls must
return its one handle after one build; each build's temporary file names
its thread; launch counts bumped from many threads add up
(tests/test_torch_cuda.py loads the real sources from four threads)."""
import threading

from repro_torch.kernels import _build


def test_concurrent_load_of_a_fake_library_returns_one_handle(
        monkeypatch, tmp_path):
    builds = []
    opened = []
    barrier = threading.Barrier(8)

    def fake_build(names):
        builds.append(list(names))
        return {name: (0.0, "cached") for name in names}

    def fake_cdll(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(_build, "build_all", fake_build)
    monkeypatch.setattr(_build, "target", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_LIBS", {})
    got = []

    def call():
        barrier.wait()
        got.append(_build.load("fake"))

    threads = [threading.Thread(target=call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(got) == 8 and len({id(h) for h in got}) == 1
    assert builds == [["fake"]] and len(opened) == 1


def test_build_temp_files_are_per_thread(tmp_path):
    lib = tmp_path / "libx-0123.so"
    names = []
    alive = threading.Barrier(5)         # no thread ends (and frees its id)
                                         # before all have named theirs

    def name():
        names.append(_build.temp_path(lib))
        alive.wait(timeout=10)

    threads = [threading.Thread(target=name) for _ in range(4)]
    for t in threads:
        t.start()
    names.append(_build.temp_path(lib))
    alive.wait(timeout=10)
    for t in threads:
        t.join()
    assert len(set(names)) == 5
    assert all(n.parent == tmp_path and n.name.endswith(".tmp")
               for n in names)


def test_launch_counts_add_up_across_threads():
    def wrapper():
        pass
    wrapper.launches = 0
    barrier = threading.Barrier(8)

    def bump():
        barrier.wait()
        for _ in range(5000):
            _build.count_launch(wrapper)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 40000
