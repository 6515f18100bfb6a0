// Minimal self-contained JSON value/parser/writer for the v2 REST
// protocol. Role parity: the reference uses TritonJson (rapidjson wrapper,
// ref:src/c++/library/json_utils.h); this build is dependency-free.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace client_tpu_torch {
namespace json {

class Value;
using Array = std::vector<Value>;
using Object = std::map<std::string, Value>;

class Value {
 public:
  enum class Type { kNull, kBool, kInt, kDouble, kString, kArray, kObject };

  Value() : type_(Type::kNull) {}
  Value(std::nullptr_t) : type_(Type::kNull) {}
  Value(bool b) : type_(Type::kBool), bool_(b) {}
  Value(int v) : type_(Type::kInt), int_(v) {}
  Value(int64_t v) : type_(Type::kInt), int_(v) {}
  Value(uint64_t v) : type_(Type::kInt), int_(static_cast<int64_t>(v)) {}
  Value(double v) : type_(Type::kDouble), dbl_(v) {}
  Value(const char* s) : type_(Type::kString), str_(s) {}
  Value(std::string s) : type_(Type::kString), str_(std::move(s)) {}
  Value(Array a) : type_(Type::kArray), arr_(std::move(a)) {}
  Value(Object o) : type_(Type::kObject), obj_(std::move(o)) {}

  Type type() const { return type_; }
  bool IsNull() const { return type_ == Type::kNull; }
  bool IsBool() const { return type_ == Type::kBool; }
  bool IsNumber() const {
    return type_ == Type::kInt || type_ == Type::kDouble;
  }
  bool IsString() const { return type_ == Type::kString; }
  bool IsArray() const { return type_ == Type::kArray; }
  bool IsObject() const { return type_ == Type::kObject; }

  bool AsBool() const { return bool_; }
  int64_t AsInt() const {
    return type_ == Type::kDouble ? static_cast<int64_t>(dbl_) : int_;
  }
  double AsDouble() const {
    return type_ == Type::kInt ? static_cast<double>(int_) : dbl_;
  }
  const std::string& AsString() const { return str_; }
  const Array& AsArray() const { return arr_; }
  Array& AsArray() { return arr_; }
  const Object& AsObject() const { return obj_; }
  Object& AsObject() { return obj_; }

  // object helpers
  bool Has(const std::string& key) const {
    return type_ == Type::kObject && obj_.count(key) > 0;
  }
  const Value& At(const std::string& key) const {
    static const Value kNull;
    auto it = obj_.find(key);
    return it == obj_.end() ? kNull : it->second;
  }
  Value& operator[](const std::string& key) {
    if (type_ == Type::kNull) type_ = Type::kObject;
    return obj_[key];
  }

  void Append(Value v) {
    if (type_ == Type::kNull) type_ = Type::kArray;
    arr_.push_back(std::move(v));
  }

  std::string Dump() const {
    std::ostringstream os;
    Write(os);
    return os.str();
  }

  void Write(std::ostream& os) const {
    switch (type_) {
      case Type::kNull: os << "null"; break;
      case Type::kBool: os << (bool_ ? "true" : "false"); break;
      case Type::kInt: os << int_; break;
      case Type::kDouble: {
        std::ostringstream tmp;
        tmp.precision(17);
        tmp << dbl_;
        os << tmp.str();
        break;
      }
      case Type::kString: WriteString(os, str_); break;
      case Type::kArray: {
        os << '[';
        for (size_t i = 0; i < arr_.size(); ++i) {
          if (i) os << ',';
          arr_[i].Write(os);
        }
        os << ']';
        break;
      }
      case Type::kObject: {
        os << '{';
        bool first = true;
        for (const auto& kv : obj_) {
          if (!first) os << ',';
          first = false;
          WriteString(os, kv.first);
          os << ':';
          kv.second.Write(os);
        }
        os << '}';
        break;
      }
    }
  }

 private:
  static void WriteString(std::ostream& os, const std::string& s) {
    os << '"';
    for (char c : s) {
      switch (c) {
        case '"': os << "\\\""; break;
        case '\\': os << "\\\\"; break;
        case '\n': os << "\\n"; break;
        case '\r': os << "\\r"; break;
        case '\t': os << "\\t"; break;
        default:
          if (static_cast<unsigned char>(c) < 0x20) {
            char buf[8];
            snprintf(buf, sizeof(buf), "\\u%04x", c);
            os << buf;
          } else {
            os << c;
          }
      }
    }
    os << '"';
  }

  Type type_;
  bool bool_ = false;
  int64_t int_ = 0;
  double dbl_ = 0.0;
  std::string str_;
  Array arr_;
  Object obj_;
};

class ParseError : public std::runtime_error {
 public:
  explicit ParseError(const std::string& msg) : std::runtime_error(msg) {}
};

class Parser {
 public:
  Parser(const char* data, size_t size) : p_(data), end_(data + size) {}

  Value Parse() {
    Value v = ParseValue();
    SkipWs();
    if (p_ != end_) throw ParseError("trailing characters");
    return v;
  }

 private:
  void SkipWs() {
    while (p_ != end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' ||
                          *p_ == '\r'))
      ++p_;
  }

  char Peek() {
    SkipWs();
    if (p_ == end_) throw ParseError("unexpected end of input");
    return *p_;
  }

  void Expect(char c) {
    if (Peek() != c)
      throw ParseError(std::string("expected '") + c + "'");
    ++p_;
  }

  Value ParseValue() {
    switch (Peek()) {
      case '{': return ParseObject();
      case '[': return ParseArray();
      case '"': return Value(ParseString());
      case 't': Literal("true"); return Value(true);
      case 'f': Literal("false"); return Value(false);
      case 'n': Literal("null"); return Value(nullptr);
      default: return ParseNumber();
    }
  }

  void Literal(const char* lit) {
    SkipWs();
    for (const char* q = lit; *q; ++q, ++p_) {
      if (p_ == end_ || *p_ != *q) throw ParseError("bad literal");
    }
  }

  Value ParseObject() {
    Expect('{');
    Object obj;
    if (Peek() == '}') { ++p_; return Value(std::move(obj)); }
    while (true) {
      std::string key = ParseString();
      Expect(':');
      obj.emplace(std::move(key), ParseValue());
      char c = Peek();
      ++p_;
      if (c == '}') break;
      if (c != ',') throw ParseError("expected ',' or '}'");
    }
    return Value(std::move(obj));
  }

  Value ParseArray() {
    Expect('[');
    Array arr;
    if (Peek() == ']') { ++p_; return Value(std::move(arr)); }
    while (true) {
      arr.push_back(ParseValue());
      char c = Peek();
      ++p_;
      if (c == ']') break;
      if (c != ',') throw ParseError("expected ',' or ']'");
    }
    return Value(std::move(arr));
  }

  std::string ParseString() {
    Expect('"');
    std::string out;
    while (p_ != end_) {
      char c = *p_++;
      if (c == '"') return out;
      if (c == '\\') {
        if (p_ == end_) break;
        char e = *p_++;
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (end_ - p_ < 4) throw ParseError("bad \\u escape");
            unsigned code = 0;
            for (int i = 0; i < 4; ++i) {
              char h = *p_++;
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else throw ParseError("bad \\u escape");
            }
            // encode UTF-8 (BMP only; surrogate pairs pass through)
            if (code < 0x80) {
              out += static_cast<char>(code);
            } else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: throw ParseError("bad escape");
        }
      } else {
        out += c;
      }
    }
    throw ParseError("unterminated string");
  }

  Value ParseNumber() {
    SkipWs();
    const char* start = p_;
    bool is_double = false;
    if (p_ != end_ && *p_ == '-') ++p_;
    while (p_ != end_ &&
           ((*p_ >= '0' && *p_ <= '9') || *p_ == '.' || *p_ == 'e' ||
            *p_ == 'E' || *p_ == '+' || *p_ == '-')) {
      if (*p_ == '.' || *p_ == 'e' || *p_ == 'E') is_double = true;
      ++p_;
    }
    std::string num(start, p_ - start);
    if (num.empty()) throw ParseError("bad number");
    try {
      if (is_double) return Value(std::stod(num));
      return Value(static_cast<int64_t>(std::stoll(num)));
    } catch (const std::exception&) {
      throw ParseError("bad number: " + num);
    }
  }

  const char* p_;
  const char* end_;
};

inline Value Parse(const std::string& s) {
  return Parser(s.data(), s.size()).Parse();
}

}  // namespace json
}  // namespace client_tpu_torch
