"""movielens: [user..., movie..., [rating]] samples + metadata accessors.

Reference: Paddle's python/paddle/v2/dataset/movielens.py — the
ml-1m zip's ::-separated {movies,users,ratings}.dat (latin-1), MovieInfo/
UserInfo metadata, a seeded random 90/10 train/test split of the ratings
stream, ratings rescaled to `r*2-5`.  Real corpus under
PADDLE_TPU_DATASET=auto|real; deterministic synthetic fallback offline.
Dictionaries (title words, categories) are SORTED here — the reference
relied on py2 set iteration order, which was not reproducible.
"""
from __future__ import annotations

import random
import re
import zipfile

from . import common
from .common import cached, fixed_rng

__all__ = [
    "train", "test", "max_user_id", "max_movie_id", "max_job_id",
    "age_table", "movie_categories", "user_info", "movie_info",
    "get_movie_title_dict", "fetch",
]

age_table = [1, 18, 25, 35, 45, 50, 56]

URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

_N_USERS, _N_MOVIES, _N_CATS, _N_JOBS = 943, 1682, 18, 20  # synthetic dims


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, title_dict):
        return [self.index,
                [categories_dict[c] for c in self.categories],
                [title_dict[w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return (f"<MovieInfo id({self.index}), title({self.title}), "
                f"categories({self.categories})>")


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age)) if int(age) in age_table \
            else int(age)
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]

    def __repr__(self):
        return (f"<UserInfo id({self.index}), "
                f"gender({'M' if self.is_male else 'F'}), "
                f"age({age_table[self.age]}), job({self.job_id})>")


def fetch():
    return common.download(URL, "movielens", MD5)


def parse_meta(zip_path):
    """-> (movies {id: MovieInfo}, users {id: UserInfo},
    title_dict, categories_dict) from an ml-1m-layout zip."""
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    movies = {}
    users = {}
    title_words = set()
    categories = set()
    with zipfile.ZipFile(zip_path) as z:
        with z.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = line.decode("latin-1").strip() \
                    .split("::")
                cats = cats.split("|")
                categories.update(cats)
                m = pattern.match(title)
                title = m.group(1).strip() if m else title
                movies[int(mid)] = MovieInfo(mid, cats, title)
                title_words.update(w.lower() for w in title.split())
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job = line.decode("latin-1").strip() \
                    .split("::")[:4]
                users[int(uid)] = UserInfo(uid, gender, age, job)
    title_dict = {w: i for i, w in enumerate(sorted(title_words))}
    categories_dict = {c: i for i, c in enumerate(sorted(categories))}
    return movies, users, title_dict, categories_dict


@cached
def _real_meta():
    path = common.fetch_real("movielens", fetch)
    if path is None:
        return None
    return (path,) + parse_meta(path)


def _ratings_reader(zip_path, movies, users, title_dict, categories_dict,
                    is_test, rand_seed=0, test_ratio=0.1):
    def reader():
        rand = random.Random(x=rand_seed)
        with zipfile.ZipFile(zip_path) as z:
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (rand.random() < test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = line.decode("latin-1").strip() \
                        .split("::")
                    mov = movies[int(mid)]
                    usr = users[int(uid)]
                    yield (usr.value() +
                           mov.value(categories_dict, title_dict) +
                           [[float(rating) * 2 - 5.0]])

    return reader


# -- synthetic fallback ------------------------------------------------------


@cached
def _synthetic_movie_info():
    r = fixed_rng("movielens/movies")
    out = {}
    for i in range(1, _N_MOVIES + 1):
        cats = [f"cat{c}" for c in r.choice(_N_CATS, size=2,
                                            replace=False)]
        out[i] = MovieInfo(i, cats, " ".join(
            f"t{int(w)}" for w in r.randint(0, 100, 3)))
    return out


@cached
def _synthetic_user_info():
    r = fixed_rng("movielens/users")
    out = {}
    for i in range(1, _N_USERS + 1):
        out[i] = UserInfo(i, "M" if r.rand() < 0.5 else "F",
                          int(age_table[r.randint(0, len(age_table))]),
                          int(r.randint(0, _N_JOBS)))
    return out


def _synthetic_reader(tag, n):
    def reader():
        r = fixed_rng("movielens/" + tag)
        for _ in range(n):
            uid = int(r.randint(1, _N_USERS + 1))
            mid = int(r.randint(1, _N_MOVIES + 1))
            gender = int(r.randint(0, 2))
            age_idx = int(r.randint(0, len(age_table)))
            job = int(r.randint(0, _N_JOBS))
            cat = int(r.randint(0, _N_CATS))
            title = [int(t) for t in r.randint(0, 100, 3)]
            # rating correlates with (uid + mid) parity-ish signal
            rating = float((uid * 7 + mid * 13) % 5 + 1)
            yield [uid, gender, age_idx, job, mid, [cat], title, [rating]]

    return reader


# -- public surface ----------------------------------------------------------


def train():
    meta = _real_meta()
    if meta is None:
        return _synthetic_reader("train", 2048)
    return _ratings_reader(*meta, is_test=False)


def test():
    meta = _real_meta()
    if meta is None:
        return _synthetic_reader("test", 512)
    return _ratings_reader(*meta, is_test=True)


def movie_info():
    meta = _real_meta()
    return _synthetic_movie_info() if meta is None else meta[1]


def user_info():
    meta = _real_meta()
    return _synthetic_user_info() if meta is None else meta[2]


def get_movie_title_dict():
    meta = _real_meta()
    if meta is None:
        return {f"t{i}": i for i in range(100)}
    return meta[3]


def movie_categories():
    meta = _real_meta()
    if meta is None:
        return {f"cat{i}": i for i in range(_N_CATS)}
    return meta[4]


def max_user_id():
    meta = _real_meta()
    if meta is None:
        return _N_USERS
    return max(meta[2])


def max_movie_id():
    meta = _real_meta()
    if meta is None:
        return _N_MOVIES
    return max(meta[1])


def max_job_id():
    meta = _real_meta()
    if meta is None:
        return _N_JOBS - 1
    return max(u.job_id for u in meta[2].values())
